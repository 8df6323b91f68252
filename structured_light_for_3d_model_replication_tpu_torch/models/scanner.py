"""SLScanner — the scan path's forward model: capture stack -> colored points.

Decode (Gray code) and triangulation (ray-plane) with the calibration held
on the device as the module's buffers, uploaded once. A batch of views is a
leading dimension: ``forward_views`` takes uint8 [V, F, H, W] and returns
one CloudResult with a leading V axis.

Three device routes, each through a CUDA kernel of ``ops/kernels.py``:

  - ``plane_eval="table"``: the decode kernel, then the plane-table gather
    and ray-plane hit as tensor ops;
  - ``plane_eval="quadratic"``, row_mode 0/1, full uint8 stacks of the
    calibrated size: the fused decode+triangulate kernel, one pass;
  - packed ingest (``forward_views_packed``): the packed-bit decode kernel,
    then the same triangulation as the table route.

Texture is one gray channel (frame 0), replicated to RGB at compaction.

``mesh=`` (a ``parallel/mesh.DeviceMesh``) shards the view axis over every
mesh slot: each shard runs the same route on its device (a replica of the
calibration buffers there) and the clouds are gathered on the scanner's
device, so a sharded call returns the unsharded call's bytes.

``forward_async`` is ``forward`` with no host wait: the frames reach the
card through pinned memory by a copy queued on the current stream, and the
call returns with the launch in flight. ``forward_views_batched`` is the
batched executor's compute lane (one launch a batch, optionally sharded).
"""
from __future__ import annotations

import copy

import numpy as np
import torch
from torch import nn

from structured_light_for_3d_model_replication_tpu_torch.ops import (
    graycode,
    kernels,
)
from structured_light_for_3d_model_replication_tpu_torch.ops import (
    triangulate as tri,
)
from structured_light_for_3d_model_replication_tpu_torch.utils.device import (
    resolve_device,
)

__all__ = ["SLScanner", "state_from_reference", "BUFFERS"]

# the calibration tensors, named as the JAX scanner's attributes
BUFFERS = ("rays", "oc", "plane_col", "plane_row", "poly_col", "poly_row")


def state_from_reference(arrays: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """Map the JAX scanner's calibration arrays (``rays, oc, plane_col,
    plane_row, poly_col, poly_row``, as numpy) onto an SLScanner
    ``state_dict``, so both packages compute from identical tensors."""
    missing = [k for k in BUFFERS if k not in arrays]
    if missing:
        raise KeyError(f"reference arrays lack {missing}")
    return {k: torch.from_numpy(np.array(arrays[k], np.float32)) for k in BUFFERS}


class SLScanner(nn.Module):
    """Decode + triangulate with device-resident calibration.

    Parameters
    ----------
    calib : dict — reference-layout calibration (Nc/Oc/wPlaneCol/wPlaneRow/
        cam_K, plus proj_K/R/T for plane_eval="quadratic")
    cam_size : (width, height) of the camera frames
    proj_size : (width, height) of the projector
    row_mode, epipolar_tol, n_sets_col, n_sets_row, downsample, plane_eval:
        see ops/graycode.py and ops/triangulate.py
    device : where the buffers live; None means "cuda"
    """

    def __init__(self, calib: dict, cam_size: tuple[int, int],
                 proj_size: tuple[int, int] = (1920, 1080),
                 row_mode: int = 1, epipolar_tol: float = 2.0,
                 n_sets_col: int = 11, n_sets_row: int = 11,
                 downsample: int = 1, plane_eval: str = "table", device=None):
        super().__init__()
        dev = resolve_device(device)
        tri.check_plane_eval(plane_eval)
        if int(row_mode) not in (0, 1, 2):
            raise ValueError(f"row_mode must be 0, 1 or 2, got {row_mode}")
        cw, ch = cam_size
        self.cam_size = (int(cw), int(ch))
        self.proj_size = (int(proj_size[0]), int(proj_size[1]))
        self.row_mode = int(row_mode)
        self.epipolar_tol = float(epipolar_tol)
        self.n_sets = (int(n_sets_col), int(n_sets_row))
        self.downsample = int(downsample)
        self.use_poly = plane_eval == "quadratic"

        rays, oc, plane_col, plane_row = tri.prep_calib(calib, ch, cw, dev)
        if self.use_poly:
            poly_col, poly_row = tri.poly_from_calib(calib, dev)
        else:
            poly_col = poly_row = torch.zeros((3, 4), dtype=torch.float32, device=dev)
        for name, t in zip(BUFFERS, (rays, oc, plane_col, plane_row, poly_col,
                                     poly_row)):
            self.register_buffer(name, t.contiguous())

    @property
    def device(self) -> torch.device:
        return self.rays.device

    def _plan(self, n_frames: int) -> graycode.DecodePlan:
        return graycode.decode_plan(
            n_frames, n_cols=self.proj_size[0], n_rows=self.proj_size[1],
            n_sets_col=self.n_sets[0], n_sets_row=self.n_sets[1],
            downsample=self.downsample)

    def _on_device(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(self.device).contiguous()
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    def _staged(self, x) -> torch.Tensor:
        """``x`` on this scanner's device without a host wait: a tensor
        already there as it is; on a card, host data through pinned memory
        (a host copy where it is pageable) and a copy queued on the current
        stream."""
        if isinstance(x, torch.Tensor) and x.device == self.device:
            return x.contiguous()
        if self.device.type != "cuda":
            return self._on_device(x)
        t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))
        if t.device.type == "cpu" and not t.is_pinned():
            t = t.contiguous().pin_memory()
        return t.to(self.device, non_blocking=True).contiguous()

    def _fuse_capable(self, frames_v: torch.Tensor) -> bool:
        """The fused kernel takes quadratic plane eval, row_mode 0/1, uint8
        stacks of the full sequence at the calibrated camera size. It masks
        its own ragged edge, so any H, W will do."""
        h, w = frames_v.shape[-2], frames_v.shape[-1]
        need = graycode.frames_per_view(*self.proj_size, self.downsample)
        return (self.use_poly and self.row_mode in (0, 1)
                and frames_v.dtype == torch.uint8
                and frames_v.shape[-3] >= need
                and (w, h) == self.cam_size)

    def _triangulate(self, col, row, mask, texture) -> tri.CloudResult:
        return tri._triangulate_impl(
            col, row, mask, texture, self.rays, self.oc, self.plane_col,
            self.plane_row, row_mode=self.row_mode,
            epipolar_tol=self.epipolar_tol,
            poly=(self.poly_col, self.poly_row) if self.use_poly else None)

    def _fused_views(self, frames_v, thr_v) -> tri.CloudResult:
        plan = self._plan(frames_v.shape[1])
        pts, valid, tex = kernels.scan_fused(
            frames_v, thr_v,
            kernels.scan_scalars(self.oc, self.poly_col, self.poly_row,
                                 self.epipolar_tol),
            self.rays, n_bits_col=plan.n_bits_col, n_bits_row=plan.n_bits_row,
            n_use_col=plan.n_use_col, n_use_row=plan.n_use_row,
            n_cols=self.proj_size[0], n_rows=self.proj_size[1],
            row_mode=self.row_mode, downsample=plan.downsample)
        return tri.CloudResult(pts, tex[..., None], valid)

    def forward(self, frames, thresh_mode: str = "otsu",
                shadow_val: float = 40.0, contrast_val: float = 10.0
                ) -> tri.CloudResult:
        """One view: frames uint8 [F, H, W] -> CloudResult [H*W] (x2 for
        row_mode 2)."""
        out = self.forward_views(self._on_device(frames)[None], thresh_mode,
                                 shadow_val, contrast_val)
        return tri.CloudResult(out.points[0], out.colors[0], out.valid[0])

    def forward_async(self, frames, thresh_mode: str = "otsu",
                      shadow_val: float = 40.0, contrast_val: float = 10.0
                      ) -> tri.CloudResult:
        """Non-blocking ``forward``: queue the upload and the kernel on the
        current stream and return with them in flight. A CUDA tensor is used
        where it is; pinned host frames are copied at once, pageable ones
        are first copied into pinned memory (a host copy, not a wait on the
        card). The caller overlaps its next load with this view and waits
        only where it reads the result (``torch.cuda.synchronize``, or a
        copy to the host). The same program and bytes as ``forward``.

        ``thresh_mode="otsu"`` needs the frames' histograms on the host to
        pick the thresholds, so that mode waits for the upload and the
        histogram as ``forward`` does; ``"manual"`` waits nowhere."""
        return self.forward(self._staged(frames), thresh_mode, shadow_val, contrast_val)

    def _replica(self, dev: torch.device) -> "SLScanner":
        """This scanner with its buffers on ``dev`` (itself on its own
        device); rebuilt when a buffer was replaced or changed in place."""
        if dev == self.device:
            return self
        key = (str(dev),) + tuple((b.data_ptr(), b._version) for b in self.buffers())
        # {key: replica}, kept out of the replicas themselves
        reps = self.__dict__.setdefault("_replicas", {})
        if key not in reps:
            for stale in [k for k in reps if k[0] == key[0]]:
                del reps[stale]
            reps[key] = copy.deepcopy(self, {id(reps): {}}).to(dev)
        return reps[key]

    def _sharded(self, mesh, inputs, run) -> tri.CloudResult:
        """``run(replica, *shards)`` on each of this process's mesh slots,
        the inputs' view axis split over every slot, the clouds gathered on
        this scanner's device."""
        from structured_light_for_3d_model_replication_tpu_torch.parallel import (
            mesh as meshlib,
        )

        v, n_dev = int(inputs[0].shape[0]), mesh.size
        if v % n_dev:
            raise ValueError(
                f"sharded view batch: {v} views not a multiple of the {n_dev}-device "
                f"mesh (the executor's bucket padding must round to the device count)")
        shards = [meshlib.batch_sharding(mesh, x) for x in inputs]
        outs = [run(self._replica(dev), *(s[k] for s in shards))
                for k, dev in enumerate(mesh.local_devices())]
        return tri.CloudResult(*(meshlib.gather_shards(list(parts), self.device)
                                 for parts in zip(*outs)))

    def forward_views(self, frames_v, thresh_mode: str = "otsu",
                      shadow_val: float = 40.0, contrast_val: float = 10.0,
                      use_fused: bool | None = None, mesh=None) -> tri.CloudResult:
        """Views: uint8 [V, F, H, W] -> CloudResult with a leading V axis.

        ``use_fused``: None takes the fused kernel wherever ``_fuse_capable``
        holds; False forces decode + triangulate; True requires the fused
        kernel (raises if the configuration cannot take it). ``mesh``: a
        DeviceMesh shards the views over its slots (V a multiple of its
        size), the same bytes as the unsharded call.
        """
        if mesh is not None:
            return self._sharded(mesh, [frames_v], lambda rep, f: rep.forward_views(
                f, thresh_mode, shadow_val, contrast_val, use_fused=use_fused))
        frames_v = self._on_device(frames_v)
        if use_fused and not self._fuse_capable(frames_v):
            raise ValueError("use_fused=True but this configuration cannot "
                             "take the fused kernel (see _fuse_capable)")
        ss, cs = graycode.resolve_thresholds_views(frames_v, thresh_mode,
                                                   shadow_val, contrast_val)
        thr_v = graycode.threshold_tensor(ss, cs, self.device)
        if self._fuse_capable(frames_v) if use_fused is None else use_fused:
            return self._fused_views(frames_v, thr_v)
        col, row, mask = graycode.decode_views(
            frames_v, thr_v, self._plan(frames_v.shape[1]))
        return self._triangulate(col, row, mask, frames_v[:, 0, ..., None])

    def forward_views_batched(self, frames_v, thresh_mode: str = "otsu",
                              shadow_val: float = 40.0, contrast_val: float = 10.0,
                              mesh=None) -> tri.CloudResult:
        """The batched executor's compute lane: uint8 [V, F, H, W] -> one
        launch for the whole batch (the fused kernel wherever
        ``_fuse_capable`` holds, else the decode kernel), the same bytes as
        ``forward_views`` and as ``forward`` view by view. ``mesh``: a
        DeviceMesh shards the views over its slots, one launch a slot; V
        must be a multiple of the mesh's size (the executor pads its
        buckets to it), else ValueError before any launch."""
        return self.forward_views(frames_v, thresh_mode=thresh_mode, shadow_val=shadow_val,
                                  contrast_val=contrast_val, mesh=mesh)

    def forward_views_packed(self, planes_v, white_v, black_v, *,
                             n_frames: int, thresh_mode: str = "otsu",
                             shadow_val: float = 40.0,
                             contrast_val: float = 10.0, mesh=None) -> tri.CloudResult:
        """Packed ingest: bit-planes u8 [V, ceil(P/8), H, W] plus the
        verbatim white/black frames [V, H, W] of stacks with ``n_frames``
        frames. Bit-identical to ``forward_views(use_fused=False)`` on the
        raw stacks: thresholds read only white/black, the texture is the
        white frame, and the planes hold decode's comparison bits. ``mesh``:
        as in ``forward_views``."""
        if mesh is not None:
            return self._sharded(
                mesh, [planes_v, white_v, black_v],
                lambda rep, p, w, b: rep.forward_views_packed(
                    p, w, b, n_frames=n_frames, thresh_mode=thresh_mode,
                    shadow_val=shadow_val, contrast_val=contrast_val))
        planes_v = self._on_device(planes_v)
        white_v = self._on_device(white_v)
        black_v = self._on_device(black_v)
        ss, cs = graycode.resolve_thresholds_views(
            torch.stack([white_v, black_v], dim=1), thresh_mode, shadow_val,
            contrast_val)
        thr_v = graycode.threshold_tensor(ss, cs, self.device)
        col, row, mask = graycode.decode_packed_views(
            planes_v, white_v, black_v, thr_v, n_frames, self._plan(n_frames))
        return self._triangulate(col, row, mask, white_v[..., None])
