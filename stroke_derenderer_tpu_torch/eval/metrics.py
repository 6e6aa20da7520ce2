"""Quality metrics, copied from the JAX ``eval/metrics.py`` (host numpy and
scipy): binarization F1 (exact and within 1 px), stroke DTW with greedy,
optimal (Hungarian) and many-to-one matching, chamfer distance and ink
coverage. They compare final artifacts (masks and polylines), not device
tensors.
"""

from __future__ import annotations

import numpy as np


def binarization_f1(pred: np.ndarray, target: np.ndarray) -> float:
    """Foreground F1 between two binary masks of the same shape."""
    p = np.asarray(pred).astype(bool).ravel()
    t = np.asarray(target).astype(bool).ravel()
    tp = np.sum(p & t)
    fp = np.sum(p & ~t)
    fn = np.sum(~p & t)
    denom = 2 * tp + fp + fn
    return float(2 * tp / denom) if denom else 1.0


def binarization_f1_tol(pred: np.ndarray, target: np.ndarray,
                        tol_px: int = 1) -> float:
    """Boundary-tolerant foreground F1: a predicted pixel counts as correct
    when ANY target pixel lies within ``tol_px`` (Chebyshev), and vice
    versa. The exact-F1 vs tol-F1 gap isolates mask-CONVENTION error
    (stroke edge width, anti-aliased halo labeling, where a traced ground
    truth and the model's masks may disagree by a pixel) from real
    segmentation error (missed strokes, rule-line false positives), which
    survives the tolerance."""
    from scipy.ndimage import binary_dilation

    p = np.asarray(pred).astype(bool)
    t = np.asarray(target).astype(bool)
    if not p.any() and not t.any():
        return 1.0
    se = np.ones((2 * tol_px + 1, 2 * tol_px + 1), bool)
    tp_p = np.sum(p & binary_dilation(t, se))  # pred pixels near target
    tp_t = np.sum(t & binary_dilation(p, se))  # target pixels near pred
    prec = tp_p / max(p.sum(), 1)
    rec = tp_t / max(t.sum(), 1)
    return float(2 * prec * rec / max(prec + rec, 1e-12))


def _dtw_loop(a: np.ndarray, b: np.ndarray) -> float:
    """Scalar-loop DTW (O(N*M) Python), the oracle the vectorized `_dtw`
    below is tested against."""
    n, m = len(a), len(b)
    if n == 0 or m == 0:
        return float("inf")
    cost = np.linalg.norm(a[:, None, :] - b[None, :, :], axis=-1)
    acc = np.full((m,), np.inf)
    acc[0] = cost[0, 0]
    for j in range(1, m):
        acc[j] = acc[j - 1] + cost[0, j]
    for i in range(1, n):
        prev = acc.copy()
        acc[0] = prev[0] + cost[i, 0]
        for j in range(1, m):
            acc[j] = cost[i, j] + min(prev[j], prev[j - 1], acc[j - 1])
    return float(acc[-1] / (n + m))  # path-length-normalized


def _dtw(a: np.ndarray, b: np.ndarray) -> float:
    """Dynamic-time-warping distance between two polylines (N,2)/(M,2),
    euclidean local cost, path-length-normalized.

    Vectorized over anti-diagonals: the DTW recurrence
    ``D[i,j] = c[i,j] + min(D[i-1,j], D[i,j-1], D[i-1,j-1])`` has no
    dependence *within* an anti-diagonal (i+j = const), so each diagonal is
    one fused numpy min over slices of the padded table — O(N+M) numpy calls
    instead of O(N*M) Python iterations."""
    n, m = len(a), len(b)
    if n == 0 or m == 0:
        return float("inf")
    cost = np.linalg.norm(a[:, None, :] - b[None, :, :], axis=-1)
    # Padded table: D[0,0]=0, inf borders; D[i,j] (1-based) = best cost of
    # aligning a[:i] with b[:j]. Identical to the classic row recurrence.
    D = np.full((n + 1, m + 1), np.inf)
    D[0, 0] = 0.0
    for d in range(2, n + m + 1):  # d = i + j over the padded coordinates
        i = np.arange(max(1, d - m), min(n, d - 1) + 1)
        j = d - i
        D[i, j] = cost[i - 1, j - 1] + np.minimum(
            np.minimum(D[i - 1, j], D[i, j - 1]), D[i - 1, j - 1])
    return float(D[n, m] / (n + m))


def _dtw_pairwise(pred: list, tgt: list) -> np.ndarray:
    """(P, T) matrix of orientation-insensitive path-normalized DTW between
    every (pred, target) polyline pair, computed in ONE batched
    anti-diagonal DP over all 2*P*T pairs — the per-diagonal numpy overhead
    that made per-pair `_dtw` slow at stroke sizes amortizes across the
    batch. Padding is causal-safe: DTW's table is lower-triangular-causal,
    so cells beyond a pair's real (n, m) endpoint never feed the value read
    at (n, m)."""
    P, T = len(pred), len(tgt)
    ns = np.array([len(p) for p in pred])
    ms = np.array([len(t) for t in tgt])
    N, M = int(ns.max()), int(ms.max())
    A = np.zeros((2 * P, N, 2))
    for i, p in enumerate(pred):
        A[i, :len(p)] = p
        A[P + i, :len(p)] = p[::-1]
    B = np.zeros((T, M, 2))
    for j, t in enumerate(tgt):
        B[j, :len(t)] = t
    cost = np.linalg.norm(
        A[:, None, :, None, :] - B[None, :, None, :, :], axis=-1
    ).reshape(2 * P * T, N, M)
    D = np.full((2 * P * T, N + 1, M + 1), np.inf)
    D[:, 0, 0] = 0.0
    for d in range(2, N + M + 1):
        i = np.arange(max(1, d - M), min(N, d - 1) + 1)
        j = d - i
        D[:, i, j] = cost[:, i - 1, j - 1] + np.minimum(
            np.minimum(D[:, i - 1, j], D[:, i, j - 1]), D[:, i - 1, j - 1])
    D = D.reshape(2, P, T, N + 1, M + 1)
    ii = np.arange(P)[:, None]
    jj = np.arange(T)[None, :]
    ends = D[:, ii, jj, ns[:, None], ms[None, :]]  # (2, P, T)
    return ends.min(axis=0) / (ns[:, None] + ms[None, :])


def stroke_dtw(pred_strokes, target_strokes) -> float:
    """Mean DTW between greedily matched stroke pairs plus an unmatched
    penalty. Strokes are (X, Y) tuples; orientation-insensitive (takes the
    better of forward/reversed). All pairwise DTWs come from one batched DP
    (`_dtw_pairwise`); greedy matching and penalties read the matrix."""
    pred = [np.stack([np.asarray(x), np.asarray(y)], -1)
            for x, y in pred_strokes if np.asarray(x).size]
    tgt = [np.stack([np.asarray(x), np.asarray(y)], -1)
           for x, y in target_strokes if np.asarray(x).size]
    if not pred and not tgt:
        return 0.0
    if not pred or not tgt:
        return float("inf")
    mat = _dtw_pairwise(pred, tgt)  # (P, T)

    used = np.zeros(len(tgt), bool)
    dists = []
    leftovers = []
    for i in range(len(pred)):
        row = np.where(used, np.inf, mat[i])
        j = int(row.argmin())  # first-min tie-break, same as the scalar scan
        if np.isfinite(row[j]):
            used[j] = True
            dists.append(float(row[j]))
        else:
            leftovers.append(i)
    # Unmatched strokes (spurious predictions or missed targets) are charged
    # their best-possible DTW against the *whole* other set — how far the
    # extra/missing stroke sits from anything real. (Reversing a target
    # equals reversing the prediction — DTW is path-reversal symmetric — so
    # the same orientation-min matrix serves both directions.)
    penalties = [float(mat[i].min()) for i in leftovers]
    penalties += [float(mat[:, j].min())
                  for j in range(len(tgt)) if not used[j]]
    total = dists + penalties
    return float(np.mean(total)) if total else float("inf")


def _prep_strokes(strokes) -> list:
    return [np.stack([np.asarray(x, np.float64), np.asarray(y, np.float64)],
                     -1)
            for x, y in strokes if np.asarray(x).size]


def stroke_dtw_assigned(pred_strokes, target_strokes) -> float:
    """`stroke_dtw` with OPTIMAL one-to-one matching (Hungarian assignment
    on the same orientation-insensitive DTW matrix) instead of the greedy
    first-seen scan. The greedy-vs-assigned gap isolates how much of the
    headline DTW is matching-procedure suboptimality rather than model
    error. Unmatched strokes are charged the same
    best-against-the-whole-other-set penalty as `stroke_dtw`."""
    from scipy.optimize import linear_sum_assignment

    pred, tgt = _prep_strokes(pred_strokes), _prep_strokes(target_strokes)
    if not pred and not tgt:
        return 0.0
    if not pred or not tgt:
        return float("inf")
    mat = _dtw_pairwise(pred, tgt)  # (P, T)
    rows, cols = linear_sum_assignment(mat)
    dists = [float(mat[i, j]) for i, j in zip(rows, cols)]
    penalties = [float(mat[i].min())
                 for i in range(len(pred)) if i not in set(rows)]
    penalties += [float(mat[:, j].min())
                  for j in range(len(tgt)) if j not in set(cols)]
    total = dists + penalties
    return float(np.mean(total)) if total else float("inf")


def stroke_dtw_split(pred_strokes, target_strokes) -> float:
    """Fragmentation-forgiving DTW: MANY-to-one matching. Every predicted
    stroke joins the ground-truth stroke it lies nearest (mean distance of
    its points to the densified target); the fragments assigned to one
    target are concatenated in target-arclength order, each oriented to
    advance along the target, and the concatenation scores ONE DTW against
    that target. A model that traces the right ink as three fragments
    scores here as if it drew one stroke — so the assigned-vs-split gap is
    the SPLIT share of the DTW deficit, and what `stroke_dtw_split` itself
    retains above chamfer is geometry/continuity error. Targets no
    fragment chose are charged their best DTW against the whole predicted
    set (missed-stroke penalty, same convention as `stroke_dtw`)."""
    pred, tgt = _prep_strokes(pred_strokes), _prep_strokes(target_strokes)
    if not pred and not tgt:
        return 0.0
    if not pred or not tgt:
        return float("inf")

    # Densified targets, with arclength position per densified point so
    # fragments can be ordered/oriented along the target's own flow.
    dtgts = []
    for t in tgt:
        d = _densify([(t[:, 0], t[:, 1])])
        seg = np.linalg.norm(np.diff(d, axis=0), axis=1)
        arl = np.concatenate([[0.0], np.cumsum(seg)])
        dtgts.append((d, arl))

    # Assign each fragment to its nearest target; record where along that
    # target its endpoints project.
    groups: dict[int, list] = {}
    for p in pred:
        best_j, best_d = -1, np.inf
        for j, (d, _) in enumerate(dtgts):
            dist = float(np.linalg.norm(p[:, None, :] - d[None, :, :],
                                        axis=-1).min(axis=1).mean())
            if dist < best_d:
                best_j, best_d = j, dist
        d, arl = dtgts[best_j]
        ends = np.linalg.norm(p[[0, -1], None, :] - d[None, :, :], axis=-1)
        pos0, pos1 = arl[ends[0].argmin()], arl[ends[1].argmin()]
        frag = p if pos0 <= pos1 else p[::-1]
        groups.setdefault(best_j, []).append((min(pos0, pos1), frag))

    dists = []
    unmatched = [j for j in range(len(tgt)) if j not in groups]
    for j, frags in groups.items():
        frags.sort(key=lambda it: it[0])
        joined = np.concatenate([f for _, f in frags])
        dists.append(_dtw(joined, tgt[j]))
    if unmatched:
        mat = _dtw_pairwise(pred, tgt)
        dists += [float(mat[:, j].min()) for j in unmatched]
    return float(np.mean(dists)) if dists else float("inf")


def strokes_chamfer(pred_strokes, target_strokes) -> float:
    """Symmetric chamfer distance over all stroke points (order-free
    sanity metric; DTW is the headline one)."""
    p = np.concatenate([np.stack([np.asarray(x), np.asarray(y)], -1)
                        for x, y in pred_strokes]) if pred_strokes else None
    t = np.concatenate([np.stack([np.asarray(x), np.asarray(y)], -1)
                        for x, y in target_strokes]) if target_strokes else None
    if p is None and t is None:
        return 0.0
    if p is None or t is None or not len(p) or not len(t):
        return float("inf")
    d = np.linalg.norm(p[:, None, :] - t[None, :, :], axis=-1)
    return float(d.min(axis=1).mean() + d.min(axis=0).mean()) / 2


def _densify(strokes, spacing: float = 1.0) -> np.ndarray | None:
    """All stroke polylines resampled at ~``spacing``-px arclength steps,
    concatenated to (N,2) — segments between sparse vertices count."""
    pts = []
    for x, y in strokes:
        x = np.asarray(x, np.float64)
        y = np.asarray(y, np.float64)
        if x.size == 0:
            continue
        if x.size == 1:
            pts.append(np.stack([x, y], -1))
            continue
        seg = np.hypot(np.diff(x), np.diff(y))
        ts = np.concatenate([[0.0], np.cumsum(seg)])
        total = max(ts[-1], 1e-9)
        t = np.linspace(0.0, total, int(np.ceil(total / spacing)) + 1)
        pts.append(np.stack([np.interp(t, ts, x), np.interp(t, ts, y)], -1))
    return np.concatenate(pts) if pts else None


def stroke_coverage(pred_strokes, target_strokes, tol: float = 3.0) -> float:
    """Fraction of ground-truth ink (densely resampled polyline points)
    within ``tol`` px of the predicted strokes. 1.0 = full coverage; an
    early EOS on dense curls shows up here as coverage well below 1 even
    when matched-stroke DTW looks fine."""
    t = _densify(target_strokes)
    if t is None:
        return 1.0
    p = _densify(pred_strokes)
    if p is None:
        return 0.0
    # Chunked min-distance: keeps the (N,M) matrix bounded.
    covered = 0
    for i in range(0, len(t), 4096):
        chunk = t[i:i + 4096]
        d = np.linalg.norm(chunk[:, None, :] - p[None, :, :], axis=-1)
        covered += int((d.min(axis=1) <= tol).sum())
    return covered / len(t)


def evaluate_pair(pred_mask, target_mask, pred_strokes, target_strokes) -> dict:
    return {
        "binarization_f1": binarization_f1(pred_mask, target_mask),
        "stroke_dtw": stroke_dtw(pred_strokes, target_strokes),
        "stroke_chamfer": strokes_chamfer(pred_strokes, target_strokes),
    }
