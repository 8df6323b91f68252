"""The device-resident clean handoff: decode output -> cleaned cloud on the
card (the JAX package's ``ops/fused_view.py``, ``pipeline.fused_clean``).

The batched lane's discrete drain copies the whole batch of decode slots to
the host, masks each view there, and ``_clean_arrays`` uploads each cloud
again for the clean chain and copies its step masks back. Here the batch's
clouds are compacted, padded to their bucket, cleaned and compacted again
on the card, and the results come to the host in one copy. The cleaned
device buffers also go to the register lane's ``prep_view_device`` as they
are, with no second upload.

The bytes equal the discrete drain's by construction:

  - the compaction is the stable valid-first order
    (``recon._compact_order_counts``), the row order host boolean masking
    gives;
  - each view's clean input is rebuilt as the very array ``_clean_arrays``
    uploads: the ``_bucket_pad(n)`` bucket, the points in the prefix, rows
    at ``knn.FAR`` after them and ``valid = arange < n``, so
    ``pc.clean_chain`` runs on the same values;
  - the final mask follows the host chain's abort at zero: step counts do
    not increase, so the first step whose count is 0 is where the host loop
    stops, else the last step.

Gray -> RGB replication runs on the host after the final slice, as in
``triangulate.compact_cloud``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from structured_light_for_3d_model_replication_tpu_torch.models import (
    reconstruction as recon,
)
from structured_light_for_3d_model_replication_tpu_torch.ops import knn as knnlib
from structured_light_for_3d_model_replication_tpu_torch.ops import pointcloud as pc

__all__ = ["FusedView", "fused_clean_views"]


@dataclass
class FusedView:
    """One cleaned view out of the fused drain: host arrays for the write
    and collect boundary, the clean counts ``_clean_arrays`` reports, and
    the compact points still on the card for ``prep_view_device``."""

    points: np.ndarray          # [n, 3] f32, final-mask compacted
    colors: np.ndarray          # [n, 3] u8 (gray replicated on the host)
    counts: dict                # {"input": n0, step: survivors, ...}
    dev_points: torch.Tensor    # [bucket, 3] f32 on the card, prefix order
    count: int                  # n: the valid prefix of dev_points


def _gather_pad(pts, cols, order, n: int, bucket: int):
    """One view's survivors (the prefix of its compaction order) in a
    ``_bucket_pad(n)`` bucket, rebuilt as ``_clean_arrays`` uploads it:
    rows at FAR and zero colours past ``n``, valid = ``arange < n``."""
    take = min(bucket, pts.shape[0])
    o = order[:take]
    p = pts.index_select(0, o)
    c = cols.index_select(0, o)
    if bucket > take:   # a nearly full view: the bucket rounds past the slots
        p = torch.cat([p, p.new_zeros((bucket - take, 3))])
        c = torch.cat([c, c.new_zeros((bucket - take, c.shape[1]))])
    keep = torch.arange(bucket, device=pts.device) < n
    p = torch.where(keep[:, None], p, torch.full_like(p, knnlib.FAR)).contiguous()
    c = torch.where(keep[:, None], c, torch.zeros_like(c))
    return p, c, keep


def _select_clean(pts, cols, masks, cnts):
    """The chain's final mask (the first step that left no point, else the
    last step) applied, survivors compacted to the prefix, on the card."""
    zero = cnts == 0
    last = torch.full_like(cnts[:1], masks.shape[0] - 1).squeeze(0)
    fidx = torch.where(zero.any(), torch.argmax(zero.to(torch.int32)), last)
    final = masks[fidx]
    order, n2 = recon._compact_order_counts(final[None])
    return pts.index_select(0, order[0]), cols.index_select(0, order[0]), n2[0]


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(-1).view(torch.uint8)


def fused_clean_views(points, colors, valid, clean_cfg, steps, timings: dict | None = None):
    """Compact, clean and compact again every view of one decoded batch on
    its device, then copy the results to the host in one copy.

    ``points`` [V, S, 3] f32, ``colors`` [V, S, C] u8, ``valid`` [V, S] bool:
    a batched ``CloudResult`` on the card. ``timings`` gets the clean
    chain's ``clean_<step>_s``. Returns ``(views, d2h_bytes, clean_s)``: a
    ``FusedView`` a view, the bytes that copy moved, and the wall spent in
    the clean chain.
    """
    params = pc.chain_params(clean_cfg, tuple(steps)) if steps else ()
    n_steps = len(params)
    order_v, cnts_d = recon._compact_order_counts(valid)
    ns = [int(n) for n in cnts_d.cpu()]          # one small [V] copy
    clean_s = 0.0
    staged = []
    for j, n in enumerate(ns):
        bucket = recon._bucket_pad(n)            # _clean_arrays' bucket
        p_b, c_b, v_b = _gather_pad(points[j], colors[j], order_v[j], n, bucket)
        if params:
            t0 = time.perf_counter()
            masks, cnt_steps = pc.clean_chain(p_b, v_b, clean_cfg, tuple(steps),
                                              timings=timings)
            p_c, c_c, n2 = _select_clean(p_b, c_b, masks, cnt_steps)
            clean_s += time.perf_counter() - t0
        else:
            p_c, c_c = p_b, c_b
            n2 = torch.tensor(n, dtype=torch.int64, device=p_b.device)
            cnt_steps = torch.zeros(0, dtype=torch.int32, device=p_b.device)
        staged.append((p_c, c_c, n2.to(torch.int32).reshape(1), cnt_steps.to(torch.int32)))
    # the one bulk copy: every view's points, colours and counts as bytes
    flat = torch.cat([_as_bytes(a) for view in staged for a in view])
    host = flat.cpu().numpy()
    views, off = [], 0

    def take(nbytes: int, dtype, shape):
        nonlocal off
        out = host[off:off + nbytes].view(dtype).reshape(shape)
        off += nbytes
        return out

    for n, (p_c, c_c, _, _) in zip(ns, staged):
        p_h = take(p_c.numel() * 4, np.float32, tuple(p_c.shape))
        c_h = take(c_c.numel(), np.uint8, tuple(c_c.shape))
        n2 = int(take(4, np.int32, (1,))[0])
        cnt = take(4 * n_steps if params else 0, np.int32, (-1,))
        counts = {"input": n}
        for i, (step, _) in enumerate(params):
            counts[step] = int(cnt[i])
            if int(cnt[i]) == 0:
                break
        c_out = np.array(c_h[:n2], np.uint8)
        if c_out.ndim == 2 and c_out.shape[-1] == 1:
            c_out = np.repeat(c_out, 3, axis=1)  # compact_cloud's gray -> RGB
        views.append(FusedView(np.array(p_h[:n2], np.float32), c_out, counts, p_c, n2))
    return views, int(flat.numel()), clean_s
