"""Stand-ins for the program that the check has to refuse: the precision
control and the planted faults.  The benchmark's own runs use none of
them; ``readings.py`` and the tests put them in the program's place.

* ``Control``: the reference in the program's place, its refined corners
  and pose solve rounded to bfloat16 (the step below the float32 the
  configurations state).
* ``AlteredAnswer``: the program, with one marker's id changed where it is
  produced (the first valid lane of each step's first frame).
* ``HalfBatch``: the program run on the first half of each batch, the
  second half's results left out (returned as no markers).
"""

from __future__ import annotations

import torch

from . import check


class Control:
    def __init__(self, config: dict, device):
        from ..reference import detect as ref
        from ..reference.dictionaries import ARDictionary

        self.ref = ref
        self.dictionary = ARDictionary.new_from_named_dict(config["dictionary"])
        self.cfg = ref.DetectorConfig(**config["detector"])
        self.scene = config["scene"]
        self.marker_mm = float(config["marker_mm"])
        self.device = torch.device(device)
        self.span = None

    def __call__(self, frames) -> dict:
        frames = frames.to(self.device)
        parts = []
        for i in range(0, frames.shape[0], check.BLOCK):
            out = self.ref.detect_batch(frames[i:i + check.BLOCK], self.dictionary, self.cfg,
                                        lowp=True)
            rot, tr, err = self.ref.solve_pose(out["marker_corners"], self.scene["width"],
                                               self.scene["height"], self.marker_mm, lowp=True)
            out.update(rotations=rot, translations=tr, errors=err)
            parts.append(out)
        return {k: torch.cat([p[k] for p in parts]) for k in check.FIELDS}


class AlteredAnswer:
    def __init__(self, config: dict, device, program):
        self.program = program(config, device)
        self.span = None

    def __call__(self, frames) -> dict:
        self.program.span = self.span
        out = dict(self.program(frames))
        ids = out["marker_id"].clone()
        first = torch.argmax(out["marker_valid"][0].to(torch.int32))
        ids[0, first] = ids[0, first] + 1
        out["marker_id"] = ids
        return out


class HalfBatch:
    def __init__(self, config: dict, device, program):
        self.program = program(config, device)
        self.span = None

    def __call__(self, frames) -> dict:
        self.program.span = self.span
        b = frames.shape[0]
        half = self.program(frames[: max(1, b // 2)])
        out = {}
        for k, v in half.items():
            rest = torch.zeros((b - v.shape[0],) + tuple(v.shape[1:]), dtype=v.dtype,
                               device=v.device)
            out[k] = torch.cat([v, rest])
        return out
