"""Checkpoints, counterparts of the JAX ``train/checkpoint.py``, in its
file layout, so that either package resumes what the other wrote:

    <ckpt_dir>/step_<n:08d>/params.msgpack      the flax params tree
                           /opt_state.msgpack   optax adamw's state tree
                           /extra_<name>.msgpack, e.g. the EMA shadow
                           /meta.json           {"step": n}

A save writes ``step_<n>.tmp`` and renames it (a stale tmp from a crashed
save is removed first); ``latest_checkpoint`` skips torn ``.tmp`` dirs.

The trees are flax's: :func:`opt_state_tree` lays ``torch.optim.AdamW``'s
state out as optax's ``adamw`` state, ``{"0": {count, mu, nu}, "1": {},
"2": {count}}`` (the Adam moments, the weight decay's empty state, the
schedule's count), ``mu``/``nu`` (``exp_avg``/``exp_avg_sq``) through the
same layout map as the params, ``count`` the optimizer's ``step``.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from stroke_derenderer_tpu_torch.weights import read_msgpack, write_msgpack


def save_checkpoint(ckpt_dir: str | Path, step: int, params: dict,
                    opt_state: dict, extras: dict | None = None,
                    keep_last: int = 0) -> Path:
    """Write ``<ckpt_dir>/step_<step>/`` from flax trees (numpy leaves);
    ``extras`` maps a name to a tree saved as ``extra_<name>.msgpack``.
    ``keep_last`` > 0 then removes all but the newest K step dirs."""
    d = Path(ckpt_dir) / f"step_{step:08d}"
    tmp = d.with_suffix(".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    write_msgpack(params, tmp / "params.msgpack")
    write_msgpack(opt_state, tmp / "opt_state.msgpack")
    for name, tree in (extras or {}).items():
        write_msgpack(tree, tmp / f"extra_{name}.msgpack")
    (tmp / "meta.json").write_text(json.dumps({"step": step}))
    if d.exists():
        shutil.rmtree(d)
    tmp.rename(d)
    if keep_last > 0:
        for p in _step_dirs(ckpt_dir)[:-keep_last]:
            shutil.rmtree(p)
    return d


def _step_dirs(ckpt_dir: str | Path) -> list[Path]:
    d = Path(ckpt_dir)
    if not d.exists():
        return []
    return sorted(p for p in d.iterdir()
                  if p.is_dir() and p.name.startswith("step_")
                  and not p.name.endswith(".tmp"))


def latest_checkpoint(ckpt_dir: str | Path) -> Path | None:
    steps = _step_dirs(ckpt_dir)
    return steps[-1] if steps else None


def restore_checkpoint(ckpt_path: str | Path, extra_names=()):
    """(step, params tree, opt_state tree, {name: tree or None}) of a
    checkpoint dir; an extra the checkpoint lacks is None."""
    p = Path(ckpt_path)
    extras = {name: (read_msgpack(p / f"extra_{name}.msgpack")
                     if (p / f"extra_{name}.msgpack").exists() else None)
              for name in extra_names}
    return (json.loads((p / "meta.json").read_text())["step"],
            read_msgpack(p / "params.msgpack"),
            read_msgpack(p / "opt_state.msgpack"), extras)


def opt_state_tree(optimizer: torch.optim.Optimizer, module: torch.nn.Module,
                   to_tree: Callable[[dict], dict]) -> dict:
    """``optimizer``'s AdamW state over ``module``'s parameters as optax's
    adamw state tree; ``to_tree`` maps a dict named like
    ``module.state_dict()`` to the flax layout. Zero moments before the
    first update."""
    count = 0
    mu, nu = {}, {}
    for name, p in module.named_parameters():
        state = optimizer.state.get(p, {})
        if "step" in state:
            count = int(state["step"])
        mu[name] = state.get("exp_avg", torch.zeros_like(p))
        nu[name] = state.get("exp_avg_sq", torch.zeros_like(p))
    c = np.asarray(count, np.int32)
    return {"0": {"count": c, "mu": to_tree(mu), "nu": to_tree(nu)},
            "1": {}, "2": {"count": c.copy()}}


def load_opt_state(optimizer: torch.optim.Optimizer, module: torch.nn.Module,
                   from_tree: Callable[[dict], dict], tree: dict) -> None:
    """Set ``optimizer``'s AdamW state over ``module``'s parameters from
    optax's adamw state tree (the inverse of :func:`opt_state_tree`)."""
    count = int(tree["0"]["count"])
    if int(tree["2"]["count"]) != count:
        raise ValueError("adam and schedule counts differ in the checkpoint")
    mu, nu = from_tree(tree["0"]["mu"]), from_tree(tree["0"]["nu"])
    for name, p in module.named_parameters():
        optimizer.state[p] = {
            "step": torch.tensor(float(count)),
            "exp_avg": mu[name].to(p.device, p.dtype).clone(),
            "exp_avg_sq": nu[name].to(p.device, p.dtype).clone()}
