"""The sharded ReSTIR frame (reference ``romis_tpu/parallel/shard.py``).

The reference has two lowerings of the sharded frame: this module's, which
constrains the pixel axis to the mesh and lets GSPMD turn the neighbour
reads into collectives, and ``parallel/halo.py``'s hand-scheduled halo
exchange. Without GSPMD there is no second lowering in PyTorch: both names
are the one band frame of ``parallel.halo.render_frame_halo``.

The reference's ``make_sharded_train_step`` (an SGD step over the sharded
frame) is not ported yet: it needs a differentiable halo exchange.
"""

from __future__ import annotations

from .halo import render_frame_halo

render_frame_sharded = render_frame_halo

__all__ = ["render_frame_sharded"]
