"""Frames back to back, as a viewer drives the renderer: the program's
``render.pipeline.render_frame`` on one generator seeded from the run's
seed, the temporal state carried from frame to frame, the camera still.
Built once in set-up; its first frames are the checked ones, and the
window goes on with the same object."""

from __future__ import annotations

import torch

from harness import scene


class Drive:
    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 size=None):
        from romis_tpu_torch.core.features import Features
        from romis_tpu_torch.render import pipeline

        self.render = pipeline.render_frame
        self.features = Features.from_dict({**config["features"],
                                            **traffic.get("features", {})})
        self.scene, self.cam, self.h, self.w = scene.build(config, device,
                                                           size)
        self.gen = torch.Generator(device=device).manual_seed(seed)
        self.state = None
        self.checked = []

    def unit(self):
        img, self.state = self.render(self.gen, self.cam, self.scene, self.h,
                                      self.w, self.features, self.state)
        return img

    def check_unit(self):
        self.checked.append(self.unit().detach().float().cpu())

    def result(self):
        """What the checked units produced: [H, W, 3] images."""
        return self.checked

    def free(self):
        self.scene = self.state = self.cam = self.gen = None
