"""Headless batch renderer of the port (reference ``romis_tpu/cli.py``, the
command-line branch of the reference's main(), src/main.cpp:178-234): read
a TOML config, load the scene, render one image per camera, write them to
the output directory, print per-image and total timings.

As the reference CLI: cameras render one after another; ``--frames N``
renders N temporally reused frames per camera (ReSTIR, through
``render_animation``), optionally checkpointed and resumed bit for bit;
``--seed`` fixes every draw. Started as several processes with the cluster
variables (``parallel/launch.py``: ``torchrun``'s, or the reference's), each
first joins the ranks and takes its GPU, as the reference's CLI does; the
renders themselves are each process's whole images.

One adaptation of the port: the reference's soup path has no size limit,
while the port's soup kernels hold at most ``ops.trace.MAX_SOUP_TRIS``
triangles, so a loaded scene above that size gets a BVH
(``ops.bvh.with_bvh``) and the CLI says so on stderr.

Usage:
    python -m romis_tpu_torch.cli --config configs/cornell.toml
    python -m romis_tpu_torch.cli --device cpu --scene model.obj \\
        --size 320 180 --frames 4 --out renders/
"""

from __future__ import annotations

import argparse
import datetime
import os
import sys
import time

import numpy as np


def _camera_seed(seed: int, camera: int) -> int:
    """The generator seed of camera ``camera``: a different stream per
    (seed, camera) pair."""
    return int(np.random.SeedSequence([seed, camera]).generate_state(1)[0])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="romis_tpu_torch headless "
                                            "renderer")
    p.add_argument("--config", help="TOML config file (reference schema)")
    p.add_argument("--scene", help="prebuilt scene name or .obj path")
    p.add_argument("--size", nargs=2, type=int, metavar=("W", "H"))
    p.add_argument("--mode", choices=["restir", "rmis", "romis"])
    p.add_argument("--frames", type=int, default=1,
                   help="temporal frames per camera (ReSTIR)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", help="output directory")
    p.add_argument("--format", choices=["png", "bmp", "npy"], default="png")
    p.add_argument("--checkpoint", metavar="PATH",
                   help="checkpoint file prefix for --frames runs: resume "
                        "from it when present, save the final temporal "
                        "state to it after rendering (bit-identical resume, "
                        "io/checkpoint.py)")
    p.add_argument("--device", help="torch device (default: the CUDA "
                                    "device; 'cpu' for the CPU)")
    p.add_argument("--save-alphas", action="store_true",
                   help="R-OMIS: save per-technique alpha visualisations")
    p.add_argument("--debug-vis", action="store_true",
                   help="save diagnostic images (hit mask, depth, normals, "
                        "shadow visibility, reservoir stats)")
    args = p.parse_args(argv)

    import torch

    # Several processes: a no-op unless the cluster variables are set
    # (parallel/launch.py); it takes the rank's GPU before anything touches
    # the card, so the same CLI serves one GPU and several.
    from .parallel.launch import maybe_init_distributed

    maybe_init_distributed(args.device)

    from .core.camera import make_camera
    from .core.device import resolve_device
    from .core.features import RayTraceMode
    from .io.config import CameraConfig, Config, read_config_file
    from .io.image import write_image
    from .ops.bvh import with_bvh
    from .ops.trace import MAX_SOUP_TRIS
    from .render.pipeline import render_frame, write_provenance
    from .render.romis import render_romis
    from .scene.scene import load_prebuilt, load_scene_from_file

    dev = resolve_device(args.device)
    if args.config:
        cfg = read_config_file(args.config)
    else:
        cfg = Config()
        cfg.cameras = [CameraConfig()]
    if args.scene:
        cfg.scene = args.scene
        cfg.scene_is_file = args.scene.endswith(".obj")
    if args.size:
        cfg.window_size = (args.size[0], args.size[1])
    if args.mode:
        cfg.features = cfg.features.replace(
            ray_trace_mode=RayTraceMode(args.mode))
    if args.out:
        cfg.output_dir = args.out

    w, h = cfg.window_size
    if cfg.scene_is_file:
        scene = load_scene_from_file(cfg.scene, cfg.lights, device=dev)
    else:
        scene = load_prebuilt(cfg.scene, cfg.data_path, device=dev)
    n_tris = int(scene.geometry.active.sum())
    if scene.geometry.tri_cols.shape[1] > MAX_SOUP_TRIS:
        t0 = time.perf_counter()
        scene.geometry = with_bvh(scene.geometry)
        print(f"scene: {n_tris} triangles exceed the soup kernels' "
              f"{MAX_SOUP_TRIS}; BVH of {scene.geometry.bvh.n_nodes} nodes "
              f"built in {time.perf_counter() - t0:.2f} s", file=sys.stderr)
    print(f"scene: {scene.name} ({n_tris} tris, {scene.num_lights} lights), "
          f"{w}x{h}, mode={cfg.features.ray_trace_mode.value}, device={dev}",
          file=sys.stderr)

    os.makedirs(cfg.output_dir, exist_ok=True)
    stamp = datetime.datetime.now().strftime("%Y-%m-%d-%H-%M-%S")
    t_total = time.perf_counter()
    for i, cam_cfg in enumerate(cfg.cameras):
        cam = make_camera(look_at=cam_cfg.look_at,
                          rotation_deg=cam_cfg.rotation,
                          distance=cam_cfg.distance_from_look_at,
                          fov_deg=cam_cfg.field_of_view, resolution=(h, w),
                          device=dev)
        seed = _camera_seed(args.seed, i)
        gen = torch.Generator(device=dev).manual_seed(seed)
        prefix = f"{cfg.output_dir}/{scene.name}_{stamp}_cam_{i}"
        t0 = time.perf_counter()
        if args.debug_vis:
            from .utils.debug_vis import debug_images, save_debug_images

            paths = save_debug_images(f"{prefix}_debug", debug_images(
                torch.Generator(device=dev).manual_seed(seed), cam, scene,
                h, w, cfg.features))
            print(f"debug images: {len(paths)} saved", file=sys.stderr)
        mode = cfg.features.ray_trace_mode
        if mode == RayTraceMode.ROMIS and args.save_alphas:
            img, alphas = render_romis(gen, cam, scene.geometry, scene.lights,
                                       scene.num_lights, h, w, cfg.features,
                                       return_alphas=True)
            alphas = alphas.detach().cpu().numpy()  # [D1, H, W, 3]
            # One image per (technique, colour channel): orange for a
            # positive alpha, blue for a negative one, scaled by |alpha|
            # (the reference's visualiseAlphas, render_utils.cpp:189-243).
            for d in range(alphas.shape[0]):
                for c, cname in enumerate(("Red", "Green", "Blue")):
                    a = alphas[d][..., c:c + 1]
                    vis = np.where(a > 0.0, a * [[1.0, 0.5, 0.0]],
                                   -a * [[0.0, 0.5, 1.0]])
                    write_image(f"{prefix}_alpha_{d}_{cname}.{args.format}",
                                np.clip(vis, 0.0, 1.0))
        elif mode == RayTraceMode.RESTIR and args.frames > 1:
            img = _animate(args, cfg, scene, cam, gen, h, w, i)
        else:
            state = None
            for _ in range(max(args.frames, 1)):
                img, state = render_frame(gen, cam, scene, h, w,
                                          cfg.features, state)
        img = img.detach().float().cpu().numpy()
        dt = (time.perf_counter() - t0) * 1000
        out_path = f"{prefix}.{args.format}"
        write_image(out_path, img)
        # The reference prints "Render time: {}ms" (main.cpp:168-170) and
        # "Image {} saved to {}" (main.cpp:224).
        print(f"Render time: {dt:.0f}ms", file=sys.stderr)
        print(f"Image {i} saved to {out_path}", file=sys.stderr)

    write_provenance(cfg.features, cfg.output_dir)
    total = (time.perf_counter() - t_total) * 1000
    print(f"Rendering took {total:.0f} ms, {len(cfg.cameras)} images "
          f"rendered.", file=sys.stderr)
    return 0


def _animate(args, cfg, scene, cam, gen, h: int, w: int, i: int):
    """--frames N > 1 of ReSTIR through ``render_animation``, resumed from
    and saved to ``<checkpoint>_cam<i>.npz`` → the last image. A resumed
    run restores the generator's state, so it renders what the
    uninterrupted run renders."""
    from .io.checkpoint import load_checkpoint, save_checkpoint
    from .render.animation import render_animation, stack_cameras
    from .render.restir import initial_temporal_state

    frames = args.frames
    start = 0
    prev = initial_temporal_state(h, w, cfg.features.num_samples_in_reservoir,
                                  cam)
    ckpt = f"{args.checkpoint}_cam{i}.npz" if args.checkpoint else None
    if ckpt and os.path.exists(ckpt):
        prev, gen_state, last_done = load_checkpoint(ckpt, prev)
        gen.set_state(gen_state)
        start = last_done + 1
        print(f"resumed {ckpt} at frame {start}", file=sys.stderr)
    if start >= frames:
        raise SystemExit(f"checkpoint {ckpt} already covers frame "
                         f"{start - 1}; raise --frames above {frames} to "
                         f"continue the run")
    imgs, state = render_animation(
        gen, stack_cameras([cam] * (frames - start)), scene.geometry,
        scene.lights, scene.num_lights, h, w, cfg.features, prev)
    if ckpt:
        if os.path.dirname(ckpt):
            os.makedirs(os.path.dirname(ckpt), exist_ok=True)
        save_checkpoint(ckpt, state, gen, frames - 1)
        print(f"checkpoint saved to {ckpt}", file=sys.stderr)
    return imgs[-1]


if __name__ == "__main__":
    sys.exit(main())
