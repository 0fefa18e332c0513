"""Traffic kind `progressive_bfx`: the requests of the `progressive` kind
with BFX as the MDR plane codec (``Config.mdr_level_compressor``), so a
refactor packs its planes with K5 on the card and a read unpacks them with
K6, in place of host zlib.

Cell parameters are the `progressive` kind's; ``config`` may name
``mdr_level_compressor`` only as "bfx", and gets it where it does not.

The control. Under ``bench_torch/control.py``'s switch (float32 matrix
products allowed in TF32, set before this kind is made) the requests run
the program on the field's float16 image, the precision below the float32
the configuration states, with TF32 turned back off: the card runs MDR's
transform in K14, which makes no matrix product, so TF32 alone leaves the
program as it is. The comparison is the same, against the field.
"""

from __future__ import annotations

import torch

from traffic.progressive import Traffic as _Progressive


class Traffic(_Progressive):
    def __init__(self, program, params: dict, cfg: dict, device):
        options = dict(params.get("config", {}))
        if options.setdefault("mdr_level_compressor", "bfx") != "bfx":
            raise ValueError("the progressive_bfx kind runs bfx planes")
        super().__init__(program, {**params, "config": options}, cfg, device)
        self.image = None
        if torch.backends.cuda.matmul.allow_tf32:
            self.image = torch.float16
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.set_float32_matmul_precision("highest")

    def request(self, field, rec):
        if self.image is not None:
            field = field.to(self.image).to(field.dtype)
        return super().request(field, rec)
