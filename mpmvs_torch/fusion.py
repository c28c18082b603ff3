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


# The consistency tolerances (within PatchMatch.cpp:403-496): reprojection
# error in pixels, relative depth difference, normal angle in radians
# (10 deg); and the dynamic weight's factors on the last two
REPROJ_MAX, REL_DD_MAX, ANGLE_MAX = 2.0, 0.01, 0.174533
DYN_DD, DYN_ANGLE = 200.0, 10.0


class _RefView(NamedTuple):
    """The reference view's side of the consistency checks."""

    K: Tensor
    R: Tensor
    t: Tensor
    depth: Tensor     # (H, W)
    normal: Tensor    # (H, W, 3)
    x: Tensor         # (H, W) pixel columns
    y: Tensor         # (H, W) pixel rows
    Xw: Tensor        # (H, W, 3) world points of the reference depths


class _SourceGates(NamedTuple):
    """The per-(source, pixel) quantities the gates test, (c, H, W)."""

    src_r: Tensor       # int64, rounded, before clamping
    src_c: Tensor
    lin: Tensor         # (c, H*W) clamped linear source pixel
    in_bounds: Tensor
    mask_s: Tensor      # the source pixel is consumed
    depth_s: Tensor
    normal_s: Tensor    # (c, H, W, 3)
    Xs: Tensor          # (c, H, W, 3) world points of the source depths
    reproj_err: Tensor
    rel_dd: Tensor
    angle: Tensor

    def tolerances(self):
        """The three tolerance gates: reprojection, depth, angle."""
        return (self.reproj_err < REPROJ_MAX, self.rel_dd < REL_DD_MAX,
                self.angle < ANGLE_MAX)

    def dynamic_weight(self, consistent: Tensor) -> Tensor:
        """exp(-(err + 200 dd + 10 angle)) where ``consistent``, else 0."""
        return torch.where(
            consistent, torch.exp(-(self.reproj_err + DYN_DD * self.rel_dd
                                    + DYN_ANGLE * self.angle)),
            torch.zeros_like(self.reproj_err))


def _ref_view(inp: FusionInput, ref_idx: int) -> _RefView:
    V, H, W = inp.depths.shape
    cams = inp.cameras
    K_r, R_r, t_r = cams.K[ref_idx], cams.R[ref_idx], cams.t[ref_idx]
    depth_r = inp.depths[ref_idx]
    x, y = geo.pixel_grid(H, W, device=inp.depths.device)
    Xw = geo.backproject_world(K_r, R_r, -(R_r.T @ t_r), x, y, depth_r)
    return _RefView(K_r, R_r, t_r, depth_r, inp.normals[ref_idx], x, y, Xw)


def _gather(a: Tensor, idx: Tensor, lin: Tensor) -> Tensor:
    """Views ``idx`` of ``a`` (V, H, W[, C]) at the pixels ``lin``."""
    c, HW = lin.shape
    sel = a[idx]
    if sel.ndim == 3:
        return torch.gather(sel.reshape(c, HW), 1, lin).reshape(sel.shape)
    C = sel.shape[-1]
    return torch.gather(sel.reshape(c, HW, C), 1,
                        lin[..., None].expand(c, HW, C)).reshape(sel.shape)


def _source_gates(inp: FusionInput, masks: Tensor, ref: _RefView,
                  idx: Tensor) -> _SourceGates:
    """Project the reference's points into the source views ``idx`` (int64),
    read the source pixels there and measure them against the reference."""
    V, H, W = inp.depths.shape
    cams = inp.cameras
    K_s, R_s, t_s = cams.K[idx], cams.R[idx], cams.t[idx]
    C_s = -torch.einsum("sji,sj->si", R_s, t_s)
    pt, proj_depth = geo.project_camera(
        K_s[:, None, None], R_s[:, None, None], t_s[:, None, None],
        ref.Xw[None])
    # (int)(x + 0.5) rounding of the reference (PatchMatch.cpp:413-414)
    src_c = _floor_to_int(pt[..., 0] + 0.5)
    src_r = _floor_to_int(pt[..., 1] + 0.5)
    in_bounds = (src_c >= 0) & (src_c < W) & (src_r >= 0) & (src_r < H)
    lin = (torch.clamp(src_r, 0, H - 1) * W
           + torch.clamp(src_c, 0, W - 1)).reshape(idx.shape[0], H * W)
    depth_s = _gather(inp.depths, idx, lin)
    normal_s = _gather(inp.normals, idx, lin)
    mask_s = _gather(masks.to(torch.int32), idx, lin) > 0
    Xs = geo.backproject_world(
        K_s[:, None, None], R_s[:, None, None], C_s[:, None, None],
        src_c.to(torch.float32), src_r.to(torch.float32), depth_s)
    back_pt, _ = geo.project_camera(ref.K, ref.R, ref.t, Xs)
    reproj_err = torch.sqrt((ref.x[None] - back_pt[..., 0]) ** 2
                            + (ref.y[None] - back_pt[..., 1]) ** 2)
    rel_dd = (torch.abs(proj_depth - ref.depth[None])
              / torch.clamp(ref.depth[None], min=1e-12))
    angle = torch.arccos(torch.clamp(geo.dot3(ref.normal[None], normal_s),
                                     -1.0, 1.0))
    angle = torch.where(torch.isnan(angle), torch.zeros_like(angle), angle)
    return _SourceGates(src_r, src_c, lin, in_bounds, mask_s, depth_s,
                        normal_s, Xs, reproj_err, rel_dd, angle)


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
    ref = _ref_view(inp, ref_idx)
    color_r = inp.colors[ref_idx]
    valid_ref = (ref.depth > 0.0) & ~masks[ref_idx]
    if inp.sky_masks is not None:
        valid_ref = valid_ref & ~inp.sky_masks[ref_idx]

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
        g = _source_gates(inp, masks, ref, idx)
        color_s = _gather(inp.colors, idx, g.lin)
        g_r, g_d, g_a = g.tolerances()
        consistent = (g.in_bounds & ~g.mask_s & (g.depth_s > 0.0)
                      & g_r & g_d & g_a & valid[:, None, None])
        w_dyn = g.dynamic_weight(consistent)
        Xs, normal_s = g.Xs, g.normal_s

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
        rc_all.append(torch.clamp(g.src_r, 0, H - 1).to(torch.int16))
        cc_all.append(torch.clamp(g.src_c, 0, W - 1).to(torch.int16))

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
    pts = (ref.Xw + Xs_sum) / cnt
    nrm = (ref.normal + nrm_sum) / cnt
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


def fusion_gate_funnel(inp: FusionInput, masks: Tensor, ref_idx: int,
                       src_indices: Tensor, src_valid: Tensor) -> dict:
    """Per-gate candidate counts for one reference view: which gate kills
    fusion candidates (counterpart of ``mpmvs_tpu.fusion.fusion_gate_funnel``,
    fusion.py:289-394).

    Replays :func:`fuse_one_view`'s per-(source, pixel) consistency chain
    (PatchMatch.cpp:403-496), through the same gates, over all S sources at
    once (diagnostic resolutions fit) and counts the survivors after each
    successive gate. Counts are cumulative, each gate ANDed with the ones
    before it, so the drop between adjacent rows is that gate's kill count.
    Then per-pixel statistics without the last-source hold-out (a diagnostic
    of the gates, not of the reference's quirk) and the candidates that fail
    only one of the three tolerance gates. Returns {name: int}."""
    ref = _ref_view(inp, ref_idx)
    valid_ref = (ref.depth > 0.0) & ~masks[ref_idx]
    g = _source_gates(inp, masks, ref, src_indices.to(torch.int64))
    g_r, g_d, g_a = g.tolerances()
    chain = []
    m = src_valid.to(ref.depth.device)[:, None, None] & valid_ref[None]
    for name, gate in (("candidates", None), ("in_bounds", g.in_bounds),
                       ("src_not_consumed", ~g.mask_s),
                       ("src_depth_pos", g.depth_s > 0.0),
                       ("reproj_lt2", g_r), ("rel_dd_lt_0.01", g_d),
                       ("angle_lt_10deg", g_a)):
        m = m if gate is None else m & gate
        chain.append((name, m))
    count = lambda t: int(t.sum())
    out = {name: count(t) for name, t in chain}
    consistent = chain[-1][1]
    n_cons = consistent.sum(0)
    dyn = g.dynamic_weight(consistent).sum(0)
    out["px_valid_ref"] = count(valid_ref)
    out["px_ncons_ge1"] = count(valid_ref & (n_cons >= 1))
    out["px_ncons_ge2"] = count(valid_ref & (n_cons >= 2))
    out["px_dynamic_accept"] = count(valid_ref & (n_cons >= 1)
                                     & (dyn > 0.3 * n_cons))
    out["px_static_accept"] = out["px_ncons_ge2"]
    live = chain[3][1]  # in bounds, not consumed, positive source depth
    out["only_reproj_fails"] = count(live & ~g_r & g_d & g_a)
    out["only_rel_dd_fails"] = count(live & g_r & ~g_d & g_a)
    out["only_angle_fails"] = count(live & g_r & g_d & ~g_a)
    return out


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
