"""Shortlist reranking: CVNet's learned correlation verification and
DELG-style geometric verification
(port of ``research_image_retrieval_tpu/index/rerank.py``).

* ``rerank_shortlist`` / ``rerank_shortlist_batched``: re-score each
  query's top-k with a pair scorer, blend with the first-stage score and
  reorder (numpy, stable order, as the JAX functions).
* ``make_cvnet_batch_scorer``: a pair scorer over cached CVNet feature
  maps, in fixed 16-pair chunks on the model's device (a tail chunk
  padded by repeating its last pair, the padded outputs dropped).
* ``mutual_nn_matches`` / ``geometric_verification_score``: the per-pair
  host check (mutual nearest neighbours, then affine RANSAC with
  ``lstsq``), numpy.
* ``geometric_verification_batch``: every pair of a chunk at once on
  ``device``: mutual-NN matching (one batched product), the valid matches
  stably sorted first, all hypotheses' 3-point affine solves, and a
  masked inlier count.  The hypotheses' uniforms come from
  ``np.random.default_rng(seed)`` in the JAX function's order.

The counts are exact functions of float32 roundings: with integer grid
coordinates a prediction is often exactly 2 px off, and the rounding of
the solve decides whether it counts.  So the batch rounds as the JAX
function does on the CPU, and the same on every device: the 3x3 solves,
predictions and squared errors are elementwise float32 operations in the
order and with the fused multiply-adds of LAPACK's kernels and XLA's
code (``_solve3x3``, ``_fma``), and the similarities are accumulated in
float64 and rounded to float32, so no device's summation order can flip
a near-tied nearest neighbour.  An exactly singular system (a triple
that picks a match twice) counts 0 inliers, as the JAX function's
non-finite predictions do; where LU leaves a rounded, nonzero pivot the
predictions are finite on both sides.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from research_image_retrieval_tpu_torch.utils.device import resolve_device

__all__ = ["geometric_verification_batch", "geometric_verification_score",
           "make_cvnet_batch_scorer", "mutual_nn_matches", "rerank_shortlist",
           "rerank_shortlist_batched"]


def rerank_shortlist(scores: np.ndarray, indices: np.ndarray,
                     pair_scorer: Callable[[int, int], float],
                     blend: float = 0.5):
    """Re-score ``[Q, k]`` shortlists pair by pair: ``blend * score +
    (1 - blend) * pair_scorer(q, g)``, reordered descending (stable).
    Returns (new_scores, new_indices)."""
    scores = np.asarray(scores)
    indices = np.asarray(indices)
    out_scores = np.empty_like(scores)
    out_idx = np.empty_like(indices)
    for qi in range(scores.shape[0]):
        ver = np.array([pair_scorer(qi, int(g)) for g in indices[qi]])
        combined = blend * scores[qi] + (1.0 - blend) * ver
        order = np.argsort(-combined, kind="stable")
        out_scores[qi] = combined[order]
        out_idx[qi] = indices[qi][order]
    return out_scores, out_idx


def rerank_shortlist_batched(scores: np.ndarray, indices: np.ndarray,
                             batch_scorer: Callable, blend: float = 0.5):
    """``rerank_shortlist`` with one scorer call over all Q*k pairs:
    ``batch_scorer(query_ids [P], gallery_ids [P]) -> [P]``."""
    scores = np.asarray(scores)
    indices = np.asarray(indices)
    Q, k = scores.shape
    qids = np.repeat(np.arange(Q), k)
    ver = np.asarray(batch_scorer(qids, indices.reshape(-1))).reshape(Q, k)
    combined = blend * scores + (1.0 - blend) * ver
    order = np.argsort(-combined, axis=1, kind="stable")
    return (np.take_along_axis(combined, order, axis=1),
            np.take_along_axis(indices, order, axis=1))


def make_cvnet_batch_scorer(model, q_fmaps, g_fmaps, chunk: int = 16):
    """``batch_scorer(query_ids [P], gallery_ids [P]) -> [P]`` match
    scores for ``rerank_shortlist_batched``: ``model`` (a
    ``CVNetRerank`` in eval mode) scores the pairs of cached feature maps
    ``q_fmaps`` [Q, H, W, C] / ``g_fmaps`` [N, H', W', C] (arrays or
    tensors, moved once to the model's device) ``chunk`` pairs at a
    time."""
    dev = next(model.parameters()).device
    q_fmaps = torch.as_tensor(q_fmaps).to(dev)
    g_fmaps = torch.as_tensor(g_fmaps).to(dev)

    def scorer(qids, gids):
        qids = np.asarray(qids)
        gids = np.asarray(gids)
        out = np.empty((len(qids),), np.float32)
        with torch.no_grad():
            for s in range(0, len(qids), chunk):
                qc, gc = qids[s:s + chunk], gids[s:s + chunk]
                n = len(qc)
                if n < chunk:  # pad to the chunk's shape
                    qc = np.concatenate([qc, np.repeat(qc[-1:], chunk - n)])
                    gc = np.concatenate([gc, np.repeat(gc[-1:], chunk - n)])
                got = model.score_from_featuremaps(
                    q_fmaps[torch.from_numpy(qc).to(dev)],
                    g_fmaps[torch.from_numpy(gc).to(dev)])
                out[s:s + n] = got[:n].cpu().numpy()
        return out

    return scorer


def mutual_nn_matches(desc_a: np.ndarray, desc_b: np.ndarray,
                      min_sim: float = 0.0):
    """(idx_a, idx_b) of the mutual nearest neighbours between [Na, D]
    and [Nb, D] L2-normalized descriptors with similarity >= min_sim."""
    sims = desc_a @ desc_b.T
    nn_ab = sims.argmax(axis=1)
    nn_ba = sims.argmax(axis=0)
    ia = np.arange(desc_a.shape[0])
    good = (nn_ba[nn_ab] == ia) & (sims[ia, nn_ab] >= min_sim)
    return ia[good], nn_ab[good]


def geometric_verification_score(locals_a, coords_a, locals_b, coords_b,
                                 ransac_iters: int = 200,
                                 inlier_px: float = 2.0,
                                 min_matches: int = 4,
                                 seed: int = 0) -> float:
    """Affine-RANSAC inlier count between two images' [N, D] local
    descriptors at [N, 2] coordinates (0 when fewer than
    ``min_matches`` mutual matches)."""
    ia, ib = mutual_nn_matches(locals_a, locals_b)
    if len(ia) < min_matches:
        return 0.0
    pa = coords_a[ia].astype(np.float64)
    pb = coords_b[ib].astype(np.float64)
    n = len(pa)
    rng = np.random.default_rng(seed)
    A_all = np.concatenate([pa, np.ones((n, 1))], axis=1)
    best = 0
    for _ in range(ransac_iters):
        sample = rng.choice(n, size=3, replace=False)
        try:
            M, *_ = np.linalg.lstsq(A_all[sample], pb[sample], rcond=None)
        except np.linalg.LinAlgError:
            continue
        err = np.linalg.norm(A_all @ M - pb, axis=1)
        best = max(best, int((err < inlier_px).sum()))
    return float(best)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` rounded once to float32 (a fused multiply-add): the
    product of two float32 values is exact in float64."""
    return (a.double() * b.double() + c.double()).float()


def _solve3x3(A: torch.Tensor, B: torch.Tensor):
    """Solve ``A [..., 3, 3] X = B [..., 3, 2]`` in float32 by LU with
    partial pivoting (the first largest |a| of each column, whole rows
    swapped), rounded as the JAX function's ``jnp.linalg.solve`` rounds
    on the CPU (LAPACK ``sgetrf`` + two ``strsm``): multipliers and
    divisions by a reciprocal, the last pivot and the substitutions with
    fused multiply-adds where those kernels use them.  Elementwise
    operations only, so every device rounds alike.  Returns (X,
    singular), ``singular`` [...] marking an exactly zero pivot (X is
    not finite there)."""
    a = [[A[..., i, j] for j in range(3)] for i in range(3)]
    b = [[B[..., i, c] for c in range(2)] for i in range(3)]
    singular = torch.zeros(A.shape[:-2], dtype=torch.bool, device=A.device)
    recip = lambda v: torch.ones_like(v) / v
    for k in range(2):
        mags = torch.stack([a[i][k].abs() for i in range(k, 3)], -1)
        piv = k + torch.argmax(mags, dim=-1)
        for i in range(k + 1, 3):
            s = piv == i
            for grid in (a, b):
                for j in range(len(grid[k])):
                    top, low = grid[k][j], grid[i][j]
                    grid[k][j] = torch.where(s, low, top)
                    grid[i][j] = torch.where(s, top, low)
        singular = singular | (a[k][k] == 0)
        inv = recip(a[k][k])
        for i in range(k + 1, 3):
            a[i][k] = a[i][k] * inv
        if k == 0:
            for i in (1, 2):
                a[i][1] = a[i][1] - a[i][0] * a[0][1]
    # the last column once both pivots are known (sgetf2 is left-looking)
    a[1][2] = a[1][2] - a[1][0] * a[0][2]
    a[2][2] = a[2][2] - _fma(a[2][1], a[1][2], a[2][0] * a[0][2])
    singular = singular | (a[2][2] == 0)
    x = []
    for c in range(2):
        y0 = b[0][c]
        y1 = _fma(-a[1][0], y0, b[1][c])
        y2 = b[2][c] - _fma(a[2][1], y1, a[2][0] * y0)
        x2 = y2 * recip(a[2][2])
        x1 = (y1 - x2 * a[1][2]) * recip(a[1][1])
        x0 = _fma(-x1, a[0][1], _fma(-x2, a[0][2], y0)) * recip(a[0][0])
        x.append(torch.stack([x0, x1, x2], -1))
    return torch.stack(x, -1), singular


def _verify_chunk(qd, qxy, gd, gxy, u, inlier_px, min_sim, min_matches):
    """(inlier counts [C], margins [C]) of C pairs of [C, L, D]
    descriptors at [C, L, 2] coordinates, with [C, H, 3] hypothesis
    uniforms.  A pair's margin is the least ``|err^2 - inlier_px^2|``
    over its hypotheses and matches: how close a rounding came to
    changing its count."""
    C, L, _ = qd.shape
    H = u.shape[1]
    sims = torch.bmm(qd.double(), gd.double().transpose(1, 2)).float()
    nn_ab = torch.argmax(sims, dim=2)  # [C, L] q-side NN in the gallery
    nn_ba = torch.argmax(sims, dim=1)  # [C, L] gallery-side NN in q
    ar = torch.arange(L, device=qd.device)
    mutual = torch.gather(nn_ba, 1, nn_ab) == ar[None, :]
    simv = torch.gather(sims, 2, nn_ab[:, :, None])[..., 0]
    valid = mutual & (simv >= min_sim)
    n = valid.sum(dim=1)  # [C] mutual matches
    # valid match slots first, in their order, so sampling indexes [0, n)
    order = torch.sort((~valid).to(torch.int32), dim=1, stable=True).indices
    take = lambda t, idx: torch.gather(t, 1, idx[:, :, None].expand(
        -1, -1, t.shape[-1]))
    pa = take(qxy, order)  # [C, L, 2]
    pb = take(take(gxy, nn_ab), order)  # matched gallery coords, same order
    slot_valid = ar[None, :] < n[:, None]
    idx = (u * n[:, None, None].to(torch.float32)).to(torch.int64)
    flat = idx.clamp(0, L - 1).reshape(C, H * 3)
    sa = take(pa, flat).reshape(C, H, 3, 2)
    sb = take(pb, flat).reshape(C, H, 3, 2)
    A = torch.cat([sa, torch.ones_like(sa[..., :1])], dim=-1)
    M, singular = _solve3x3(A, sb)  # [C, H, 3, 2]
    # [x y 1] @ M and the squared error, rounded as XLA's CPU code does
    pred = _fma(pa[:, None, :, 1:2], M[:, :, None, 1, :],
                pa[:, None, :, 0:1] * M[:, :, None, 0, :]) \
        + M[:, :, None, 2, :]  # [C, H, L, 2]
    d = pred - pb[:, None]
    err2 = _fma(d[..., 1], d[..., 1], d[..., 0] * d[..., 0])
    live = slot_valid[:, None, :] & ~singular[:, :, None]
    ok = (err2 < inlier_px * inlier_px) & live
    best = ok.sum(dim=-1).amax(dim=1)
    margin = torch.where(live, (err2 - inlier_px * inlier_px).abs(),
                         torch.inf).nan_to_num(torch.inf).amin(dim=(1, 2))
    return torch.where(n >= min_matches, best, 0).to(torch.float32), margin


def geometric_verification_batch(q_desc, q_xy, g_desc, g_xy,
                                 ransac_iters: int = 200,
                                 inlier_px: float = 2.0,
                                 min_sim: float = 0.0, min_matches: int = 4,
                                 seed: int = 0, chunk: int = 32,
                                 device="cuda", margins: bool = False):
    """Affine-RANSAC inlier counts of P pairs on ``device``.

    Args:
      q_desc / g_desc: [P, L, D] L2-normalized local descriptors of each
        pair's two sides (gather rows first: ``q_desc_all[qids]``).
      q_xy / g_xy: [P, L, 2] their coordinates.
      chunk: pairs per batch; the last chunk is padded with its last
        pair, as the JAX function's fixed shape is.

    Returns:
      [P] float32 inlier counts (0 with fewer than ``min_matches`` mutual
      matches), and with ``margins`` also each pair's least ``|err^2 -
      inlier_px^2|`` (how near a rounding came to changing its count).
      Each chunk draws its [chunk, iters, 3] uniforms from
      ``np.random.default_rng(seed)`` in order, as the JAX function does.
    """
    dev = resolve_device(device)
    arrays = [np.asarray(a, np.float32) for a in (q_desc, q_xy, g_desc,
                                                  g_xy)]
    P = arrays[0].shape[0]
    rng = np.random.default_rng(seed)
    out = np.empty((P,), np.float32)
    margin = np.empty((P,), np.float32)
    with torch.no_grad():
        for s in range(0, P, chunk):
            e = min(s + chunk, P)
            pad = chunk - (e - s)
            part = [torch.from_numpy(np.concatenate(
                [a[s:e], np.repeat(a[e - 1:e], pad, 0)]) if pad else a[s:e])
                .to(dev) for a in arrays]
            u = torch.from_numpy(rng.random((chunk, int(ransac_iters), 3),
                                            np.float32)).to(dev)
            got, near = _verify_chunk(*part, u, inlier_px, min_sim,
                                      min_matches)
            out[s:e] = got.cpu().numpy()[:e - s]
            margin[s:e] = near.cpu().numpy()[:e - s]
    return (out, margin) if margins else out
