"""The correctness check of a page-batch cell: what the window's calls
produced, held against the plain reference (``reference/``), layer by
layer, on the lines of the calls drawn for it.

Numbers (each lower is better; the limits of those compared in
``limits/<cell>.json``, the others printed as readings):

- ``mask_px_share``: the binarizer's masks against the reference's (UNet
  in float32, the same resize, tiles, threshold and stitch): the share of
  mask pixels that differ.
- ``glyph_count_off``: lines whose glyph count differs from the
  reference's partition of the same strokes-stage mask (exact: 0).
- ``crop_px_off``: crop pixels more than one grey level from the
  reference's crop (exact up to the rounding of a half level: 0).
- ``feat_rel_err``: the decoder's input (encoder features, after the
  projection where there is one) against the reference's features of its
  own crops: the worst row's relative L2 error (``feat_rel_err_mean``:
  the mean over rows).
- ``token_gap``: the widest gap by which the logit of a token the program
  wrote lies below the reference's best logit at that step (under beam
  search: its k-th best, k the beam width, since every token of the
  chosen beam was one of the k best of its step), the reference fed the
  program's tokens (teacher forcing) over its own features, up to and
  including the row's EOS. ``token_miss_share`` is the share of those
  steps with any gap, ``row_miss_share`` the share of rows with a gap at
  any step (one row that runs on its drifted state counts once, not at
  each of its steps), ``token_gap_mean`` the mean gap; ``row_gap_worst``
  the largest of the rows' mean gaps, ``rows_gap_over_<x>`` the rows whose
  mean gap is over x. ``decode_steps_mean`` and ``_max``: the steps the
  written rows ran, through their EOS.
- Under beam search, over every beam K2 returned: ``beam_pick_off``, rows
  whose written tokens are not the beam that K2's own scores rank first
  under the length penalty (exact: 0); ``beam_score_err`` (worst) and
  ``beam_score_err_mean``: each beam's score against the reference's sum
  of its log-probabilities, teacher-forced over its own features;
  ``beam_pick_gap`` (worst) and ``beam_pick_gap_mean``: by how much the
  reference's best beam of a row, by those sums and the length penalty,
  beats the beam written.
- ``poly_off``: lines whose polylines differ from those the reference
  makes of the program's tokens on its own partition (exact: 0).

The strokes stage is judged from the mask the window handed it (the
program's own in binarized cells): the reference follows the program
there step by step, and the mask is judged on its own by the first
number.

``control="fp8"`` puts the reference computed in float8
(``models.low_precision``) in the program's place: its masks and
features are judged instead of the program's, and at each step of the
program's tokens the token it puts first.
"""

from __future__ import annotations

import numpy as np
import torch

import encoders
from reference import geometry, models

ROW_GAP_OVER = (0.1, 0.2, 0.3, 0.5)


def _blocks(n: int, size: int):
    return [(i, min(i + size, n)) for i in range(0, n, size)]


def _mask(tw, img, b: dict, device, low=None) -> np.ndarray:
    """The reference binarizer's mask of one line, (H, W) uint8 0/255."""
    rs = geometry.resize_to_height(img, b["height"])
    tiles = geometry.cut_tiles(rs, b["width"], b["overlap"])
    with models.low_precision(low):
        probs = torch.cat([models.unet(tw["binarizer"], torch.as_tensor(
            tiles[i:j], device=device)) for i, j in _blocks(len(tiles), 32)])
    m = np.where(probs.cpu().numpy() > b["bin_thr"], 255, 0).astype(np.uint8)
    return geometry.stitch_tiles(m[..., None], rs.shape[1], b["overlap"])[..., 0]


def _features(tw, crops: torch.Tensor, s: dict, low=None) -> torch.Tensor:
    with models.low_precision(low):
        f = encoders.family(s["encoder_arch"]).forward(
            tw["encoder"], models.normalize_crops(crops, s["mean"], s["std"]))
        return models.dense(f, tw["projection"]) if tw["projection"] is not None else f


@torch.no_grad()
def numbers(kept: list, trees: dict, cfg: dict, traffic: dict, device,
            control: str | None = None) -> dict:
    """``kept``: per drawn call, a dict with ``images`` (the lines given),
    ``bins`` (the binarizer's masks), ``masks`` (what the strokes stage was
    given), ``strokes`` (its output per line) and the probe's ``crops``,
    ``inv``, ``counts``, ``seq``, ``tokens`` and, under beam search,
    ``beams`` (K2's preds, scores and lengths)."""
    models.setup()
    low = control if control == "fp8" else None
    b, s = cfg["binarizer"], cfg["strokes"]
    tw = {k: models.to_tensors(v, device) if v is not None else None
          for k, v in trees.items()}
    out = {}

    # The binarizer.
    diff = total = 0
    for call in kept:
        for img, port in zip(call["images"], call["bins"]):
            ref = _mask(tw, img, b, device)
            port = _mask(tw, img, b, device, low) if low else np.asarray(port)[..., 0]
            total += ref.size
            diff += ref.size if port.shape != ref.shape else int((port != ref).sum())
    out["mask_px_share"] = diff / max(total, 1)

    # The strokes stage, row by row.
    size = s["image_size"]
    beam = traffic["decode"] == "beam"
    count_off = poly_off = 0
    ref_crops, port_crops, port_seq, tokens, beams = [], [], [], [], []
    for call in kept:
        perm_inv = torch.as_tensor(call["inv"], device=call["crops"].device)
        crops = call["crops"][perm_inv]
        seq = call["seq"][perm_inv]
        kb = [x[perm_inv.to(x.device)] for x in call["beams"]] if beam else None
        row = 0
        tok_iter = iter(call["tokens"])
        # Lines the strokes stage gave no glyph count for were never
        # partitioned by it: each is off.
        missing = len(call["masks"]) - len(call["counts"])
        count_off += missing
        poly_off += missing
        for mask, n, port_strokes in zip(call["masks"], call["counts"], call["strokes"]):
            parts = geometry.partition(np.asarray(mask).astype(np.uint8), s["margin"], size)
            toks = next(tok_iter) if n else np.zeros((0, s["max_length"]), np.int32)
            if len(parts) != n:
                count_off += 1
                poly_off += 1
                row += n
                continue
            if n:
                ref_crops.append(np.stack([p[0] for p in parts]))
                port_crops.append(crops[row:row + n])
                port_seq.append(seq[row:row + n])
                tokens.append(np.asarray(toks))
                if beam:
                    beams.append([x[row:row + n] for x in kb])
            strokes = geometry.sort_strokes([st for (crop, t1, r, t2), tk in zip(parts, toks)
                                             for st in geometry.glyph_strokes(tk, size, t1, r, t2)])
            same = len(strokes) == len(port_strokes) and all(
                np.array_equal(x, px) and np.array_equal(y, py)
                for (x, y), (px, py) in zip(strokes, port_strokes))
            poly_off += not same
            row += n
    out["glyph_count_off"] = count_off
    out["poly_off"] = poly_off
    if not ref_crops:
        empty = (("crop_px_off", "feat_rel_err", "feat_rel_err_mean", "token_gap",
                  "token_miss_share", "row_miss_share", "token_gap_mean", "row_gap_worst")
                 + tuple(f"rows_gap_over_{x}" for x in ROW_GAP_OVER)
                 + (("beam_pick_off", "beam_score_err_mean") if beam else ()))
        out |= dict.fromkeys(empty, 0.0)
        return out

    ref_u8 = np.concatenate(ref_crops)
    port_c = torch.cat(port_crops).float()
    port_s = torch.cat(port_seq)
    tok = torch.as_tensor(np.concatenate(tokens), device=device)
    n = len(ref_u8)
    off = 0
    feats = torch.empty((n,) + tuple(port_s.shape[1:]), device=device)
    ctrl = torch.empty_like(feats) if low else None
    for i, j in _blocks(n, 128):
        rc = torch.as_tensor(ref_u8[i:j], device=device).float()
        off += int(((port_c[i:j].to(device) - rc).abs() > 1).sum())
        feats[i:j] = _features(tw, rc, s)
        if low:
            ctrl[i:j] = _features(tw, rc, s, low)
    out["crop_px_off"] = off
    ps = ctrl if low else port_s.to(device).float()
    rel = ((ps - feats).flatten(1).norm(dim=1)
           / feats.flatten(1).norm(dim=1).clamp_min(1e-30))
    out["feat_rel_err"] = float(rel.max())
    out["feat_rel_err_mean"] = float(rel.mean())
    eos = tok == models.EOS
    steps = torch.where(eos.any(1), eos.int().argmax(1) + 1, tok.shape[1]).float()
    out["decode_steps_mean"], out["decode_steps_max"] = float(steps.mean()), int(steps.max())
    out |= _token_numbers(tw["decoder"], feats, ctrl, tok, traffic["beam_size"] if beam else 1, low)
    if beam and not low:
        preds, score, lens = (torch.cat([x[i] for x in beams]).to(device) for i in range(3))
        out |= _beam_numbers(tw["decoder"], feats, tok, preds, score, lens,
                             traffic.get("length_penalty", 0.0))
    return out


def _token_numbers(dec, feats, ctrl, tok, k: int, low) -> dict:
    """The program's tokens fed to the reference over its own features; at
    each step the gap of the written token (under the control, the token
    the control puts first) below the reference's k-th best logit. Rows
    stop after writing their EOS."""
    n = len(tok)
    gap = torch.zeros(n, device=feats.device)
    row_sum = torch.zeros(n, device=feats.device)
    row_steps = torch.zeros(n, device=feats.device)
    row_missed = torch.zeros(n, dtype=torch.bool, device=feats.device)
    missed = 0
    lower = models.forced_logits(dec, ctrl, tok, low) if low else None
    for t, logits, alive in models.forced_logits(dec, feats, tok):
        written = next(lower)[1].argmax(1, keepdim=True) if low else tok[:, t:t + 1].long()
        g = (logits.topk(k, dim=1).values[:, -1] - logits.gather(1, written)[:, 0]).clamp_min(0)
        g = torch.where(alive, g, torch.zeros_like(g))
        gap = torch.maximum(gap, g)
        row_sum += g
        row_steps += alive
        missed += int((g > 0).sum())
        row_missed |= g > 0
    steps = max(float(row_steps.sum()), 1.0)
    row_mean = row_sum / row_steps.clamp_min(1)
    out = {"token_gap": float(gap.max()), "token_miss_share": missed / steps,
           "row_miss_share": float(row_missed.sum()) / max(n, 1),
           "token_gap_mean": float(row_sum.sum()) / steps,
           "row_gap_worst": float(row_mean.max())}
    for x in ROW_GAP_OVER:
        out[f"rows_gap_over_{x}"] = int((row_mean > x).sum())
    return out


def _beam_numbers(dec, feats, tok, preds, score, lens, length_penalty: float) -> dict:
    """Every beam K2 returned, (n, K, T) preds with their (n, K) scores and
    lengths, against the reference's sums of log-probabilities, each beam
    teacher-forced over its row's features."""
    n, k, length = preds.shape
    rows = torch.arange(n, device=preds.device)
    pen = ((5.0 + lens.float()) / 6.0) ** length_penalty if length_penalty > 0 else 1.0
    first = (score / pen).argmax(dim=1)   # the first on ties, as K2's choice
    pick_off = int((preds[rows, first] != tok).any(dim=1).sum())
    ref = torch.zeros(n * k, device=feats.device)
    for i, j in _blocks(n, 256):
        bt = preds[i:j].reshape(-1, length)
        acc = torch.zeros(len(bt), device=feats.device)
        for t, logits, alive in models.forced_logits(dec, feats[i:j].repeat_interleave(k, 0), bt):
            lp = models.log_softmax(logits).gather(1, bt[:, t:t + 1].long())[:, 0]
            acc += torch.where(alive, lp, torch.zeros_like(lp))
        ref[i * k:j * k] = acc
    ref = ref.view(n, k)
    err = (score - ref).abs()
    ranked = ref / pen
    pick = ranked.max(dim=1).values - ranked[rows, first]
    return {"beam_pick_off": pick_off, "beam_score_err": float(err.max()),
            "beam_score_err_mean": float(err.mean()), "beam_pick_gap": float(pick.max()),
            "beam_pick_gap_mean": float(pick.mean())}
