"""Multi-view depth-map fusion to a coloured point cloud.

Counterpart of ``mpmvs_tpu.fusion`` (RunFusion, src/PatchMatch.cpp:287-504).
Each reference view's consistency checks run as tensor ops on the device of
the inputs; views run in sequence to honour the consumed-pixel masking
(PatchMatch.cpp:470-474, 491-494). Source views are processed in chunks of
``SRC_CHUNK`` (a loop in place of the JAX package's ``lax.scan``), so the
per-view temporaries are (SRC_CHUNK, H, W).

Acceptance (PatchMatch.cpp:403-496): reprojection error < 2 px, relative
depth difference < 0.01, normal angle < 10 deg; then static (>= 2
consistent neighbours) or dynamic consistency (sum exp(-(err + 200 dd +
10 ang)) > 0.3 n, n >= 1). The reference's quirk is kept: the last present
source view of a reference view counts only where an earlier one matched.
Within one reference view the pixel-serial mask updates are one parallel
step (the JAX package's documented relaxation).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from mpmvs_torch import geometry as geo
from mpmvs_torch.camera import CameraStack

Tensor = torch.Tensor

# Source views processed per chunk: bounds the (chunk, H, W) temporaries.
SRC_CHUNK = 4


class FusionInput(NamedTuple):
    """All views' data stacked (padded to a common shape beforehand)."""

    depths: Tensor    # (V, H, W)
    normals: Tensor   # (V, H, W, 3) world frame
    colors: Tensor    # (V, H, W, 3) BGR float
    cameras: CameraStack
    sky_masks: Optional[Tensor] = None  # (V, H, W) bool, True = sky (skip)


class ViewFusion(NamedTuple):
    points: Tensor     # (H*W, 3)
    normals: Tensor    # (H*W, 3)
    colors: Tensor     # (H*W, 3)
    accept: Tensor     # (H*W,) bool
    used: Tensor       # (S, H, W) bool — which src pixels were consumed
    src_r: Tensor      # (S, H, W) int16
    src_c: Tensor      # (S, H, W) int16


def fuse_one_view(inp: FusionInput, masks: Tensor, ref_idx: int,
                  src_indices: Tensor, src_valid: Tensor,
                  use_dynamic: bool = True) -> ViewFusion:
    """Consistency-check one reference view against its source views.

    masks: (V, H, W) bool — already-consumed pixels. ``src_indices`` (S,)
    int (padded); ``src_valid`` (S,) bool marks real entries."""
    V, H, W = inp.depths.shape
    if H >= 32768 or W >= 32768:
        raise ValueError(f"fusion stores int16 pixel coordinates; got {(H, W)}")
    dev = inp.depths.device
    cams = inp.cameras
    K_r, R_r, t_r = cams.K[ref_idx], cams.R[ref_idx], cams.t[ref_idx]
    C_r = -(R_r.T @ t_r)
    depth_r = inp.depths[ref_idx]
    normal_r = inp.normals[ref_idx]
    color_r = inp.colors[ref_idx]
    mask_r = masks[ref_idx]

    x, y = geo.pixel_grid(H, W, device=dev)
    valid_ref = (depth_r > 0.0) & ~mask_r
    if inp.sky_masks is not None:
        valid_ref = valid_ref & ~inp.sky_masks[ref_idx]

    Xw = geo.backproject_world(K_r, R_r, C_r, x, y, depth_r)  # (H, W, 3)

    S = src_indices.shape[0]
    n_src = int(src_valid.sum())
    last_pos = max(n_src - 1, 0)  # position of the last real source

    zeros = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=dev)
    n_cons = torch.zeros((H, W), dtype=torch.int32, device=dev)
    dyn, Xs_sum, nrm_sum, col_sum = zeros(H, W), zeros(H, W, 3), \
        zeros(H, W, 3), zeros(H, W, 3)
    last_cons = torch.zeros((H, W), dtype=torch.bool, device=dev)
    last_dyn, last_Xs, last_nrm, last_col = zeros(H, W), zeros(H, W, 3), \
        zeros(H, W, 3), zeros(H, W, 3)
    cons_all, rc_all, cc_all = [], [], []

    for start in range(0, S, SRC_CHUNK):
        idx = src_indices[start:start + SRC_CHUNK].to(torch.int64)
        valid = src_valid[start:start + SRC_CHUNK]
        pos = torch.arange(start, start + idx.shape[0], device=dev)
        K_s, R_s, t_s = cams.K[idx], cams.R[idx], cams.t[idx]
        C_s = -torch.einsum("sji,sj->si", R_s, t_s)
        c = idx.shape[0]

        pt, proj_depth = geo.project_camera(
            K_s[:, None, None], R_s[:, None, None], t_s[:, None, None],
            Xw[None])
        # (int)(x + 0.5) rounding of the reference (PatchMatch.cpp:413-414)
        src_c = _floor_to_int(pt[..., 0] + 0.5)
        src_r = _floor_to_int(pt[..., 1] + 0.5)
        in_bounds = (src_c >= 0) & (src_c < W) & (src_r >= 0) & (src_r < H)
        cc = torch.clamp(src_c, 0, W - 1)
        rc = torch.clamp(src_r, 0, H - 1)
        lin = (rc * W + cc).reshape(c, H * W)

        def gather_src(a: Tensor) -> Tensor:
            sel = a[idx]
            if sel.ndim == 3:
                return torch.gather(sel.reshape(c, H * W), 1,
                                    lin).reshape(c, H, W)
            Cc = sel.shape[-1]
            return torch.gather(sel.reshape(c, H * W, Cc), 1,
                                lin[..., None].expand(c, H * W, Cc)
                                ).reshape(c, H, W, Cc)

        depth_s = gather_src(inp.depths)
        normal_s = gather_src(inp.normals)
        color_s = gather_src(inp.colors)
        mask_s = gather_src(masks.to(torch.int32)) > 0

        Xs = geo.backproject_world(
            K_s[:, None, None], R_s[:, None, None], C_s[:, None, None],
            src_c.to(torch.float32), src_r.to(torch.float32), depth_s)
        back_pt, _ = geo.project_camera(K_r, R_r, t_r, Xs)
        reproj_err = torch.sqrt((x[None] - back_pt[..., 0]) ** 2
                                + (y[None] - back_pt[..., 1]) ** 2)
        rel_dd = (torch.abs(proj_depth - depth_r[None])
                  / torch.clamp(depth_r[None], min=1e-12))
        dot = torch.clamp(geo.dot3(normal_r[None], normal_s), -1.0, 1.0)
        angle = torch.arccos(dot)
        angle = torch.where(torch.isnan(angle), torch.zeros_like(angle), angle)

        consistent = (in_bounds & ~mask_s & (depth_s > 0.0)
                      & (reproj_err < 2.0) & (rel_dd < 0.01)
                      & (angle < 0.174533) & valid[:, None, None])
        w_dyn = torch.where(
            consistent, torch.exp(-(reproj_err + 200.0 * rel_dd
                                    + 10.0 * angle)),
            torch.zeros_like(reproj_err))

        # the last real source is held out of the accumulators; its gated
        # contribution is added after the loop (PatchMatch.cpp:404-405)
        is_last = (pos == last_pos)[:, None, None]
        contrib = consistent & ~is_last
        cw = contrib[..., None]
        n_cons = n_cons + torch.sum(contrib, 0, dtype=torch.int32)
        dyn = dyn + torch.sum(torch.where(contrib, w_dyn, 0.0), 0)
        Xs_sum = Xs_sum + torch.sum(torch.where(cw, Xs, 0.0), 0)
        nrm_sum = nrm_sum + torch.sum(torch.where(cw, normal_s, 0.0), 0)
        col_sum = col_sum + torch.sum(torch.where(cw, color_s, 0.0), 0)

        lm = consistent & is_last
        lw = lm[..., None]
        last_cons = last_cons | torch.any(lm, 0)
        last_dyn = last_dyn + torch.sum(torch.where(lm, w_dyn, 0.0), 0)
        last_Xs = last_Xs + torch.sum(torch.where(lw, Xs, 0.0), 0)
        last_nrm = last_nrm + torch.sum(torch.where(lw, normal_s, 0.0), 0)
        last_col = last_col + torch.sum(torch.where(lw, color_s, 0.0), 0)

        cons_all.append(consistent)
        rc_all.append(rc.to(torch.int16))
        cc_all.append(cc.to(torch.int16))

    # gate: the last source only counts where earlier sources matched
    gate = (n_cons > 0) & last_cons
    gf = gate[..., None]
    n_cons = n_cons + gate.to(torch.int32)
    dyn = dyn + torch.where(gate, last_dyn, 0.0)
    Xs_sum = Xs_sum + torch.where(gf, last_Xs, 0.0)
    nrm_sum = nrm_sum + torch.where(gf, last_nrm, 0.0)
    col_sum = col_sum + torch.where(gf, last_col, 0.0)

    if use_dynamic:
        accept = (n_cons >= 1) & (dyn > 0.3 * n_cons)
    else:
        accept = n_cons >= 2
    accept = accept & valid_ref

    cnt = (n_cons + 1.0)[..., None]
    pts = (Xw + Xs_sum) / cnt
    nrm = (normal_r + nrm_sum) / cnt
    col = (color_r + col_sum) / cnt

    consistent = torch.cat(cons_all)
    # apply the gate to the stored last-source bits so `used` matches
    is_last_all = (torch.arange(S, device=dev) == last_pos)[:, None, None]
    consistent = torch.where(is_last_all, consistent & gate[None], consistent)
    used = consistent & accept[None]
    return ViewFusion(points=pts.reshape(-1, 3), normals=nrm.reshape(-1, 3),
                      colors=col.reshape(-1, 3), accept=accept.reshape(-1),
                      used=used, src_r=torch.cat(rc_all),
                      src_c=torch.cat(cc_all))


def _floor_to_int(v: Tensor) -> Tensor:
    """floor(v) as int64, with non-finite and far out-of-range values mapped
    off-image (the saturating conversion of the JAX package)."""
    f = torch.nan_to_num(torch.floor(v), nan=-1.0, posinf=2.0 ** 31,
                         neginf=-(2.0 ** 31))
    return torch.clamp(f, -(2.0 ** 31), 2.0 ** 31).to(torch.int64)


def _mark_used(masks: Tensor, out: ViewFusion, ref_idx: int,
               src_indices: Tensor) -> Tensor:
    """Consume the accepted reference pixels and their supporting source
    pixels."""
    V, H, W = masks.shape
    masks = masks.clone()
    masks[ref_idx] |= out.accept.reshape(H, W)
    flat = masks.reshape(V, H * W)
    lin = out.src_r.to(torch.int64) * W + out.src_c.to(torch.int64)
    for si in range(src_indices.shape[0]):
        hit = lin[si][out.used[si]]
        if hit.numel():
            flat[int(src_indices[si])].index_fill_(0, hit, True)
    return flat.reshape(V, H, W)


def run_fusion(depths, normals, colors, cameras: CameraStack, scenes,
               use_dynamic: bool = True, sky_masks=None, device=None):
    """Fuse all estimated views into one point cloud.

    depths (V, H, W), normals (V, H, W, 3), colors (V, H, W, 3) BGR;
    ``scenes``: list of Scene (src_ids[0] == ref id); ``sky_masks``
    optional (V, H, W) bool, True where a reference pixel is sky and fuses
    no point (fusion.py:103-104 of the JAX package). Computes on
    ``device`` (default: the device of ``cameras``). Returns (points,
    normals, colors) numpy arrays."""
    dev = torch.device(device) if device is not None else cameras.device
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32).to(dev)
    depths = f32(depths)
    V, H, W = depths.shape
    inp = FusionInput(depths=depths, normals=f32(normals), colors=f32(colors),
                      cameras=cameras.to(dev),
                      sky_masks=None if sky_masks is None else
                      torch.as_tensor(np.asarray(sky_masks, bool)).to(dev))
    masks = torch.zeros((V, H, W), dtype=torch.bool, device=dev)
    id2idx = {s.ref_id: i for i, s in enumerate(scenes) if s.estimate}
    max_src = max((len(s.src_ids) - 1 for s in scenes if s.estimate),
                  default=0)
    max_src = max(max_src, 1)

    all_pts, all_nrm, all_col = [], [], []
    for s in scenes:
        if not s.estimate:
            continue
        i = id2idx[s.ref_id]
        src = [id2idx[j] for j in s.src_ids[1:] if j in id2idx]
        src_valid = torch.zeros(max_src, dtype=torch.bool, device=dev)
        src_valid[:len(src)] = True
        src_idx = torch.zeros(max_src, dtype=torch.int64, device=dev)
        if src:
            src_idx[:len(src)] = torch.tensor(src, device=dev)
        out = fuse_one_view(inp, masks, i, src_idx, src_valid,
                            use_dynamic=use_dynamic)
        acc = out.accept
        all_pts.append(out.points[acc].cpu().numpy())
        all_nrm.append(out.normals[acc].cpu().numpy())
        all_col.append(out.colors[acc].cpu().numpy())
        masks = _mark_used(masks, out, i, src_idx)

    if not all_pts:
        z = np.zeros((0, 3), np.float32)
        return z, z.copy(), z.copy()
    return (np.concatenate(all_pts), np.concatenate(all_nrm),
            np.concatenate(all_col))
