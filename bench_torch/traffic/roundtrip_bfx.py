"""Traffic kind `roundtrip_bfx`: the requests of the `roundtrip` kind with
BFX as the lossless stage (``Config.lossless``), so a call runs the Hybrid
codec's flag 0 (the K7/K8 front end, then K5/K6) and bypasses BFP.

Cell parameters are the `roundtrip` kind's; ``config`` may name
``lossless`` only as "BFX", and gets it where it does not.
"""

from __future__ import annotations

from traffic.roundtrip import Traffic as _Roundtrip


class Traffic(_Roundtrip):
    def __init__(self, program, params: dict, cfg: dict, device):
        options = dict(params.get("config", {}))
        if options.setdefault("lossless", "BFX") != "BFX":
            raise ValueError("the roundtrip_bfx kind runs lossless BFX")
        super().__init__(program, {**params, "config": options}, cfg, device)
