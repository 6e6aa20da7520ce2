"""The glyph encoders, one family per file, found by the name that a
configuration gives as ``strokes.encoder_arch``.

A family ``encoders/<family>.py`` lists the names it serves in ``ARCHS``
and holds, for a configuration's ``strokes`` section ``s``:

- ``shapes(s)``: the leaf shapes of ``strokes_encoder.msgpack`` as the
  program loads it, its leaves named by ``harness.weights.draw``'s kinds
  (``kernel``, ``bias``, ``scale``, ``embedding``, ``mean``, ``var``);
- ``forward(tree, images)``: the plain float32 reference, (N, S, S, 3)
  normalized crops to (N, P, width) features, every conv and matmul
  operand through ``reference.models._q`` so that the fp8 control rounds
  it;
- ``width(s)`` and ``positions(s)``: the feature width and P;
- ``flops(s)``: the operations of one crop, counted as
  ``torch.utils.flop_counter.FlopCounterMode`` counts them.

A family's own per-layer metrics may read whatever else it defines.

``family`` loads only the files that an arch's name selects: those whose
stem begins the name and is followed there by no letter (``vit_l16``
selects ``vit.py`` and ``vit_l.py``, ``vitals`` selects neither). So no
cell runs the file of a family it does not use. Like ``reference/``, a family imports nothing of the program under
test and nothing of JAX (``tests/test_bench_guard.py`` holds every file
here to that).
"""

from __future__ import annotations

import functools
import re
from pathlib import Path

from harness.cell import load_file

DIR = Path(__file__).resolve().parent


@functools.cache
def load(path: Path):
    """The family module of the file ``path``."""
    return load_file(path, "bench_encoder_")


def selects(arch: str, path: Path) -> bool:
    """Whether the name ``arch`` selects the family file ``path``."""
    return re.match(re.escape(path.stem) + "(?![A-Za-z])", arch) is not None


def family(arch: str):
    """The one module, of the files that ``arch`` selects, whose ``ARCHS``
    names ``arch``."""
    files = sorted(p for p in DIR.glob("*.py") if p.name != "__init__.py")
    chosen = [p for p in files if selects(arch, p)]
    hits = [p for p in chosen if arch in load(p).ARCHS]
    if len(hits) != 1:
        served = (", ".join(p.name for p in hits) if hits else
                  "none of the files it selects ("
                  + (", ".join(p.name for p in chosen) or "none") + ")")
        raise LookupError(
            f"encoder_arch {arch!r} is served by {served}; files in {DIR}: "
            + ", ".join(p.name for p in files) + ". Exactly one family's ARCHS "
            "has to name it, in a file whose stem begins the name")
    return load(hits[0])
