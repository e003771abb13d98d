"""RAFT-Stereo forward, test mode and train mode (the port of
``raft_stereo_tpu.models.raft_stereo``).

Encoders, the all-pairs correlation pyramid, ``iters`` refinement
iterations (pyramid lookup -> update block) in a Python loop, and the
convex upsample: once, of the final iteration, in test mode; of every
iteration in train mode, as one batched upsample after the loop (the
default ``deferred_upsample``) or inside each iteration.

Train mode runs the JAX package's training schedules: the encoder remat
modes (``remat_encoders``), per-iteration recomputation with its save
policies (``remat_refinement``, ``refinement_save_policy``,
``residual_dtype``), the batched-weight-gradient backward
(``batched_scan_wgrad``, ``ops/scan_grad.py``), and the fused loss
(``flow_gt`` and ``loss_mask`` given: per-iteration masked L1 sums instead
of the prediction stack, reduced in the loop or after it in tile layout,
chunked by :func:`upsample_chunk_count`, the tail recomputed in the
backward under ``remat_loss_tail``). The shape-dependent resolvers
(:func:`refinement_save_policy_fits`, :func:`upsample_chunk_count`) are
the JAX package's, with its constants, so that one config resolves to the
same schedule in both packages.

With ``fused_lookup`` on and a volume-pyramid implementation whose
pyramid fits (``ops/kernels/fused_lookup.fused_lookup_applicable``), each
iteration skips the lookup and the motion encoder runs the lookup and
``convc1`` as one fused kernel, as the JAX package gates it.

Mixed precision follows the JAX package's policy, not ``autocast``:
parameters stay fp32, convs run in the compute dtype (bf16 under
``mixed_precision``), norm statistics are fp32 and the correlation taps
are blended in fp32. The coordinates stay fp32 throughout.
"""

from __future__ import annotations

import functools
import warnings
from typing import Optional

import torch
import torch.nn as nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from raft_stereo_tpu_torch.config import RAFTStereoConfig
from raft_stereo_tpu_torch.nn.encoder import (BasicEncoder,
                                              MultiBasicEncoder,
                                              remat_block_names)
from raft_stereo_tpu_torch.nn.gru import (BasicMultiUpdateBlock,
                                          numerics_taps, record_numerics_tap)
from raft_stereo_tpu_torch.nn.layers import Conv, ResidualBlock
from raft_stereo_tpu_torch.ops.corr import (corr_lookup, init_corr,
                                            state_tensors, with_tensors)
from raft_stereo_tpu_torch.ops.geometry import (convex_upsample_tiles,
                                                coords_grid,
                                                image_to_upsample_tiles,
                                                upsample_disparity_convex,
                                                upsample_tiles_to_image)
from raft_stereo_tpu_torch.ops.kernels.fused_lookup import \
    fused_lookup_applicable
from raft_stereo_tpu_torch.ops.scan_grad import refinement_scan

# fp32 working-set budget of the post-loop batched upsample before the
# fused loss's tail is chunked over the iterations (a module constant so
# that tests can force the chunked path at small shapes).
_UPSAMPLE_TILE_BUDGET = 1024 * 1024 * 1024


# ---- shape-dependent schedule selection -----------------------------------
#
# The JAX package's resolvers with its constants: a 16 GB TPU v5e's
# calibration at the SceneFlow recipe's shapes, not the H100's (80 GB).
# They are copied unchanged so that one config resolves to the same
# schedule in both packages; recalibrating them for the card is a
# performance item (ROADMAP.md A9b).

def refinement_save_policy_fits(cfg, iters: int, batch: int, h: int, w: int,
                                dt, fused_lookup: bool = False,
                                residual_dtype=None) -> bool:
    """Whether the auto save policy (``refinement_save_policy=None``)
    engages: the tagged values (every GRU level's gate outputs, each
    slow-fast pre-pass's too, and the correlation) of ``iters``
    iterations at ``batch`` on the ``h x w`` grid (1/factor resolution)
    take at most 1.5 GB, at 2 bytes a value when the compute dtype ``dt``
    or ``residual_dtype`` is bf16, else 4. The fused lookup has no
    correlation tensor to keep."""
    per_px = 3.0 * cfg.hidden_dims[2] + cfg.corr_channels
    if cfg.n_gru_layers >= 2:
        per_px += 3.0 * cfg.hidden_dims[1] / 4
    if cfg.n_gru_layers == 3:
        per_px += 3.0 * cfg.hidden_dims[0] / 16
    if cfg.slow_fast_gru:
        if cfg.n_gru_layers == 3:
            per_px += 2 * 3.0 * cfg.hidden_dims[0] / 16
        if cfg.n_gru_layers >= 2:
            per_px += 3.0 * cfg.hidden_dims[1] / 4
    bytes_per = 2 if (dt == torch.bfloat16
                      or residual_dtype in ("bfloat16", torch.bfloat16)) \
        else 4
    saved_bytes = int(iters * batch * h * w * per_px * bytes_per)
    if fused_lookup:
        saved_bytes -= iters * batch * h * w * cfg.corr_channels * bytes_per
    return saved_bytes <= 1_500_000_000


def resolve_save_kinds(cfg, iters: int, batch: int, h: int, w: int, dt,
                       fused_lookup: bool = False) -> frozenset:
    """The values the training refinement keeps an iteration for its
    backward (``ops/scan_grad.py``'s ``save_kinds``), as the JAX package's
    ``_refine`` resolves ``refinement_save_policy`` at this shape: none
    without ``remat_refinement``; ``{"corr"}`` under ``"corr"``; the gate
    outputs and the lookup, ``{"zr", "q", "corr"}``, under True, or under
    None where :func:`refinement_save_policy_fits` holds; no lookup with
    the fused lookup, whose ``"corr"`` policy warns and keeps nothing
    (full per-iteration recompute)."""
    if not cfg.remat_refinement:
        return frozenset()
    engage = cfg.refinement_save_policy
    if engage is None:
        engage = refinement_save_policy_fits(
            cfg, iters, batch, h, w, dt, fused_lookup=fused_lookup,
            residual_dtype=cfg.residual_dtype)
    if engage == "corr":
        if fused_lookup:
            warnings.warn(
                "refinement_save_policy='corr' has no effect with "
                "fused_lookup (no corr_feats tensor exists to save); "
                "using full per-iteration remat")
            return frozenset()
        return frozenset({"corr"})
    if not engage:
        return frozenset()
    return frozenset({"zr", "q"} if fused_lookup else {"zr", "q", "corr"})


def upsample_chunk_count(it: int, batch: int, hp: int, wp: int, factor: int,
                         budget: Optional[int] = None) -> int:
    """Chunks of the fused loss's post-loop upsample over the ``it``
    iterations: 1 when the ``(it*B, h, w, f, f)`` fp32 working set fits
    ``budget`` (None: ``_UPSAMPLE_TILE_BUDGET``), else the smallest
    divisor of ``it`` whose chunk fits, else ``it``."""
    if budget is None:
        budget = _UPSAMPLE_TILE_BUDGET
    tile_bytes = batch * hp * wp * (9 + 2) * factor ** 2 * 4
    nch = 1
    if it * tile_bytes > budget:
        nch = it
        for cand in range(2, it + 1):
            if it % cand:
                continue
            if (it // cand) * tile_bytes <= budget:
                nch = cand
                break
    return nch


# The "norms" encoder schedule keeps these ops' outputs (every conv output
# and the norms' means and variances) and recomputes the rest.
_NORMS_SAVED = (torch.ops.aten.convolution.default,
                torch.ops.aten._slow_conv2d_forward.default,
                torch.ops.aten.mean.dim)


def _norms_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _NORMS_SAVED
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn, mode, *args):
    """``fn(*args)`` under an encoder remat ``mode``: True recomputes all
    of it in the backward, ``"norms"`` all but the outputs of
    ``_NORMS_SAVED``."""
    if mode == "norms":
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=functools.partial(
                              create_selective_checkpoint_contexts,
                              _norms_policy))
    return checkpoint(fn, *args, use_reentrant=False)


class RAFTStereo(nn.Module):
    """The flagship model, NHWC at its interface.

    ``forward(image1, image2, iters, flow_init=None, test_mode=True)``
    takes uint8-range images ``(B, H, W, 3)`` and returns, in test mode,
    ``(flow_lowres (B, H/f, W/f, 2), flow_up (B, H, W, 1))``; in train mode
    the ``(iters, B, H, W, 1)`` stack of every iteration's upsampled
    x-flow (negative disparity), or, given ``flow_gt`` and ``loss_mask``
    (the fused loss), ``(err_sums (iters,), flow_up (B, H, W, 1))``: each
    iteration's masked L1 sum and the final prediction.

    ``iter_metrics`` (test mode only) adds the per-iteration mean
    |Δ disparity|, how far each iteration still moves the low-res field
    (the convergence curve the serving path records): ``True`` gives the
    batch-mean curve ``(iters,)``, ``"per_sample"`` the ``(iters, B)``
    means over H and W; the return becomes ``(flow_lowres, flow_up,
    delta_norms)``. With ``iter_metrics=False`` nothing else changes.

    ``flow_gt`` (``(B, H, W, 1)``, with ``iter_metrics``; ``loss_mask``
    of the same shape marks its valid pixels) adds the per-iteration
    low-res EPE against the factor-pooled GT, shaped like the residuals,
    after them. ``numerics=True`` adds a dict of ``(iters, 6)`` tap
    statistics stacks (nn/gru.py), always the last element.
    ``adaptive_tau`` (with ``iter_metrics="per_sample"``, not with
    ``numerics``) runs the early exit of :meth:`_refine_adaptive`:
    ``iters`` is the budget, and ``iters_taken (B,)`` follows the residual
    (and EPE) stacks. These are the JAX package's return orders and
    guards.

    ``dtype`` overrides the compute dtype that ``cfg.mixed_precision``
    selects (bf16 when set, fp32 otherwise).
    """

    def __init__(self, cfg: RAFTStereoConfig,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.cfg = cfg
        if dtype is None:
            dtype = torch.bfloat16 if cfg.mixed_precision else torch.float32
        self.compute_dtype = dtype
        dt = dtype
        hd = cfg.hidden_dims
        self.cnet = MultiBasicEncoder(
            output_dim=(hd, hd), norm_fn=cfg.context_norm,
            downsample=cfg.n_downsample, num_layers=cfg.n_gru_layers,
            dtype=dt)
        self.update_block = BasicMultiUpdateBlock(cfg, dt)
        self.context_zqr_convs = nn.ModuleList(
            Conv(hd[i], hd[i] * 3, 3, 1, 1, dt)
            for i in range(cfg.n_gru_layers))
        if cfg.shared_backbone:
            self.conv2 = nn.Sequential(
                ResidualBlock(128, 128, "instance", 1, dt),
                Conv(128, 256, 3, 1, 1, dt))
        else:
            self.fnet = BasicEncoder(output_dim=256, norm_fn="instance",
                                     downsample=cfg.n_downsample, dtype=dt)

    def storage_dtype(self) -> Optional[torch.dtype]:
        """Correlation storage (the volume, or the features of the
        feature-pyramid implementations): the config's choice, else the
        compute dtype for the kernel implementations and fp32 for ``reg``
        and ``alt``."""
        cfg = self.cfg
        if cfg.corr_storage_dtype is not None:
            return getattr(torch, cfg.corr_storage_dtype)
        if cfg.corr_implementation in ("reg_pallas", "alt_pallas", "fused"):
            return self.compute_dtype
        return None

    def uses_fused_lookup(self, corr_state) -> bool:
        """Whether the iterations run the fused lookup+convc1 kernel: asked
        for (``fused_lookup=True``; None is off), a volume pyramid (``reg``
        or ``reg_pallas``) and a pyramid the kernel takes."""
        return (bool(self.cfg.fused_lookup)
                and corr_state.impl in ("reg", "reg_pallas")
                and fused_lookup_applicable(corr_state.levels,
                                            corr_state.radius))

    def forward(self, image1: torch.Tensor, image2: torch.Tensor,
                iters: int = 12, flow_init: Optional[torch.Tensor] = None,
                test_mode: bool = True, iter_metrics=False,
                flow_gt: Optional[torch.Tensor] = None,
                loss_mask: Optional[torch.Tensor] = None,
                numerics: bool = False,
                adaptive_tau: Optional[float] = None,
                adaptive_min_iters: int = 1):
        if iters < 1:
            raise ValueError(f"iters must be >= 1, got {iters}")
        if iter_metrics not in (False, True, "per_sample"):
            raise ValueError(f"iter_metrics must be False, True or "
                             f"'per_sample', got {iter_metrics!r}")
        if iter_metrics and not test_mode:
            raise ValueError("iter_metrics is a test-mode output")
        if test_mode and flow_gt is not None and not iter_metrics:
            raise ValueError("the test-mode iter-EPE output rides the "
                             "iter_metrics outputs; pass iter_metrics=True "
                             "or 'per_sample'")
        if flow_gt is not None and not test_mode and loss_mask is None:
            raise ValueError("the fused-loss path needs both flow_gt and "
                             "loss_mask (see training.loss.loss_mask)")
        if numerics and not test_mode:
            raise ValueError("the numerics taps are a test-mode output; "
                             "the training side is the per-leaf gradient "
                             "norms (training/state.py numerics=True)")
        if adaptive_tau is not None:
            if not test_mode:
                raise ValueError("adaptive early exit (adaptive_tau) is "
                                 "a test-mode path")
            if iter_metrics != "per_sample":
                raise ValueError("adaptive early exit requires "
                                 "iter_metrics='per_sample': the per-sample "
                                 "residual drives the freeze mask")
            if numerics:
                raise ValueError("numerics taps are not supported on the "
                                 "adaptive path; record numerics on the "
                                 "fixed-trip loop")
            if adaptive_tau < 0:
                raise ValueError(f"adaptive_tau must be >= 0, got "
                                 f"{adaptive_tau}")
        cfg = self.cfg

        image1 = 2.0 * (image1.float() / 255.0) - 1.0
        image2 = 2.0 * (image2.float() / 255.0) - 1.0

        cnet_list, fmap1, fmap2 = self._encode(image1, image2)

        net_list = [torch.tanh(x[0]) for x in cnet_list]
        # context gate biases (cz, cr, cq), computed once outside the loop
        inp_list = [tuple(conv(torch.relu(x[1])).chunk(3, dim=-1))
                    for conv, x in zip(self.context_zqr_convs, cnet_list)]

        corr_state = init_corr(cfg.corr_implementation, fmap1, fmap2,
                               num_levels=cfg.corr_levels,
                               radius=cfg.corr_radius,
                               storage_dtype=self.storage_dtype())

        b, h, w, _ = net_list[0].shape
        coords0 = coords_grid(b, h, w, device=image1.device)
        coords1 = coords0.clone()
        if flow_init is not None:
            # keep the flow's y-channel structurally zero
            coords1 = coords1 + torch.stack(
                [flow_init[..., 0], torch.zeros_like(flow_init[..., 0])], -1)

        fused = self.uses_fused_lookup(corr_state)
        if not test_mode:
            return self._train_refine(net_list, inp_list, corr_state,
                                      coords0, coords1, iters, fused,
                                      flow_gt, loss_mask)
        per_sample = iter_metrics == "per_sample"
        iter_epe = None
        if flow_gt is not None:
            iter_epe = self._iter_epe(flow_gt, loss_mask, coords0,
                                      per_sample)
        if adaptive_tau is not None:
            return self._refine_adaptive(
                net_list, inp_list, corr_state, coords0, coords1, iters,
                float(adaptive_tau), int(adaptive_min_iters), iter_epe,
                fused)
        mask = None
        residuals, epes, taps = [], [], []
        for itr in range(iters):
            previous = coords1
            last = itr == iters - 1
            if numerics:
                # armed one iteration at a time: each iteration's taps are
                # one row of the stacks, the final (mask-head) one last
                with numerics_taps() as sink:
                    net_list, coords1, mask = self._iteration(
                        net_list, inp_list, corr_state, coords0, coords1,
                        compute_mask=last, fused=fused)
                taps.append(sink)
            else:
                net_list, coords1, mask = self._iteration(
                    net_list, inp_list, corr_state, coords0, coords1,
                    compute_mask=last, fused=fused)
            if iter_metrics:
                d = (coords1 - previous)[..., 0].abs()
                residuals.append(d.mean(dim=(1, 2)) if per_sample
                                 else d.mean())
            if iter_epe is not None:
                epes.append(iter_epe(coords1))
        flow_lowres = coords1 - coords0
        flow_up = upsample_disparity_convex(flow_lowres, mask.float(),
                                            cfg.factor)
        ret = (flow_lowres, flow_up)
        if iter_metrics:
            ret += (torch.stack(residuals),)
        if iter_epe is not None:
            ret += (torch.stack(epes),)
        if numerics:
            # one (iters, 6) stack a tap; the dict is always last
            ret += ({k: torch.stack([t[k] for t in taps])
                     for k in taps[-1]},)
        return ret

    def _encode(self, image1, image2):
        """The encoders, under ``cfg.remat_encoders`` while autograd
        records (JAX ``__call__``'s ``_cnet_fwd``/``_fnet_fwd``): True or
        ``"norms"`` around each whole encoder, ``"blocks"`` and
        ``"blocks_hires"`` around the trunk blocks of
        :func:`remat_block_names` (the context encoder saved whole under
        ``"blocks_hires"`` unless the backbone is shared). Returns
        ``(cnet_list, fmap1, fmap2)``."""
        cfg = self.cfg
        mode = cfg.remat_encoders if torch.is_grad_enabled() else False
        blocks = remat_block_names(mode, cfg.n_downsample)
        cnet_blocks = blocks
        if mode == "blocks_hires" and not cfg.shared_backbone:
            cnet_blocks = frozenset()
        whole = mode in (True, "norms")

        def run(fn, *args):
            return _remat(fn, mode, *args) if whole else fn(*args)
        if cfg.shared_backbone:
            *cnet_list, trunk = run(
                lambda x: self.cnet(x, dual_inp=True, remat=cnet_blocks),
                torch.cat([image1, image2], 0))
            fmap1, fmap2 = self.conv2(trunk).chunk(2, dim=0)
        else:
            cnet_list = run(lambda x: self.cnet(x, remat=cnet_blocks),
                            image1)
            fmap1, fmap2 = run(lambda x: self.fnet(x, remat=blocks),
                               torch.cat([image1, image2], 0)
                               ).chunk(2, dim=0)
        return cnet_list, fmap1, fmap2

    def _iter_epe(self, flow_gt, loss_mask, coords0, per_sample):
        """The per-iteration low-res EPE proxy: the full-resolution GT
        (``(B, H, W, 1)``, negative disparity) pooled to the flow grid once
        by mask-weighted means (``loss_mask`` marks valid pixels; a cell
        with none is left out), then one masked reduction an iteration.
        Returns ``epe(coords1)``: ``(B,)`` per sample, else the batch
        mean."""
        f = self.cfg.factor
        b, h, w = coords0.shape[:3]
        gt = flow_gt.float()[..., 0]
        m = (torch.ones_like(gt) if loss_mask is None
             else loss_mask.float()[..., 0])
        gt_c = gt.reshape(b, h, f, w, f)
        m_c = m.reshape(b, h, f, w, f)
        msum = m_c.sum(dim=(2, 4))
        gt_pool = (gt_c * m_c).sum(dim=(2, 4)) / msum.clamp(min=1.0)
        cell_valid = (msum > 0).float()
        denom = cell_valid.sum(dim=(1, 2)).clamp(min=1.0)

        def epe(coords1):
            err = ((coords1 - coords0)[..., 0] * f - gt_pool).abs()
            e = (err * cell_valid).sum(dim=(1, 2)) / denom
            return e if per_sample else e.mean()
        return epe

    def _refine_adaptive(self, net_list, inp_list, corr_state, coords0,
                         coords1, budget, tau, min_iters, iter_epe, fused):
        """Early-exit test-mode refinement (JAX ``_refine_adaptive``).

        The fixed loop's iteration, with a per-sample freeze mask in the
        carry: once an applied update moved a sample's disparity field
        less than ``tau`` (mean |Δ disparity| in low-res px, strict ``<``,
        after at least ``min_iters`` applied updates) the sample freezes;
        later iterations compute the body and ``torch.where`` keeps the
        old carry, so its residual row is 0.0. ``budget`` (``iters``) is
        the trip count; ``iters_taken`` counts applied updates, the final
        iteration's included. The final iteration always runs with the
        mask head and respects the mask.

        ``cfg.adaptive_mode``: ``"masked_scan"`` runs the ``budget - 1``
        trips with no host sync; ``"while_loop"`` stops once every sample
        has frozen, and to know that it reads the batch's mask on the host
        before each trip: one host sync an iteration (the JAX package's
        ``lax.while_loop`` decides on the device). Rows after such a stop
        stay 0.0 (EPE rows too). The two give bitwise-equal flows and
        ``iters_taken``; ``tau=0`` never freezes a sample, so the flow is
        bitwise the fixed loop's at the same budget.

        Returns ``(flow_lowres, flow_up, residuals (budget, B)[, epes
        (budget, B)], iters_taken (B,) int32)``."""
        b = net_list[0].shape[0]
        dev = coords0.device
        active = torch.ones(b, dtype=torch.bool, device=dev)
        taken = torch.zeros(b, dtype=torch.int32, device=dev)
        zero = torch.zeros((), device=dev)

        def advance(nets, coords, act, tk, new_nets, new_coords):
            r = (new_coords - coords)[..., 0].abs().mean(dim=(1, 2))
            m = act[:, None, None, None]
            nets = [torch.where(m, n2, n1)
                    for n1, n2 in zip(nets, new_nets)]
            coords = torch.where(m, new_coords, coords)
            row = torch.where(act, r, zero)
            tk = tk + act.to(torch.int32)
            act = act & ((r >= tau) | (tk < min_iters))
            return nets, coords, act, tk, row

        rows, epe_rows = [], []
        while_loop = self.cfg.adaptive_mode == "while_loop"
        for _ in range(budget - 1):
            if while_loop and not bool(active.any()):
                break
            new_nets, new_coords, _unused = self._iteration(
                net_list, inp_list, corr_state, coords0, coords1,
                compute_mask=False, fused=fused)
            net_list, coords1, active, taken, row = advance(
                net_list, coords1, active, taken, new_nets, new_coords)
            rows.append(row)
            if iter_epe is not None:
                epe_rows.append(iter_epe(coords1))
        # rows of the trips a whole-batch stop skipped
        for _ in range(budget - 1 - len(rows)):
            rows.append(torch.zeros(b, device=dev))
            if iter_epe is not None:
                epe_rows.append(torch.zeros(b, device=dev))
        new_nets, new_coords, up_mask = self._iteration(
            net_list, inp_list, corr_state, coords0, coords1,
            compute_mask=True, fused=fused)
        net_list, coords1, active, taken, row = advance(
            net_list, coords1, active, taken, new_nets, new_coords)
        rows.append(row)
        flow_lowres = coords1 - coords0
        flow_up = upsample_disparity_convex(flow_lowres, up_mask.float(),
                                            self.cfg.factor)
        ret = (flow_lowres, flow_up, torch.stack(rows))
        if iter_epe is not None:
            epe_rows.append(iter_epe(coords1))
            ret += (torch.stack(epe_rows),)
        return ret + (taken,)

    def _iteration(self, net_list, inp_list, corr_state, coords0, coords1,
                   compute_mask: bool, fused: bool = False, tap=None):
        """One refinement iteration: lookup at the (detached) coordinates,
        the update block, the epipolar coordinate update. Returns
        ``(net_list, coords1, mask)``; ``mask`` is None unless
        ``compute_mask``. With ``fused`` the lookup happens inside the
        motion encoder's fused kernel. ``tap`` (``ops/scan_grad.py``)
        computes the lookup and the gate convs, per update-block
        application (``pre32``, ``pre16``, ``main``)."""
        cfg = self.cfg
        dt = self.compute_dtype
        block = self.update_block
        n = cfg.n_gru_layers
        coords1 = coords1.detach()
        if fused:
            corr = None
            fused_args = dict(corr_state=corr_state,
                              coords_x=coords1[..., 0].contiguous())
        elif tap is not None:
            corr = tap.corr_site(corr_state, coords1, dt)
            fused_args = {}
        else:
            corr = corr_lookup(corr_state, coords1).to(dt)
            record_numerics_tap(corr, "corr_feats")
            fused_args = {}

        def scope(prefix):
            return None if tap is None else tap.scoped(prefix)
        flow = (coords1 - coords0).to(dt)
        if cfg.slow_fast_gru and n == 3:
            net_list = block(net_list, inp_list, iter32=True, iter16=False,
                             iter08=False, update=False, tap=scope("pre32"))
        if cfg.slow_fast_gru and n >= 2:
            net_list = block(net_list, inp_list, iter32=n == 3, iter16=True,
                             iter08=False, update=False, tap=scope("pre16"))
        net_list, mask, delta_flow = block(
            net_list, inp_list, corr, flow, iter32=n == 3, iter16=n >= 2,
            compute_mask=compute_mask, tap=scope("main"), **fused_args)
        # stereo: project the update onto the epipolar line (the JAX
        # package's flow head computes the x channel alone, so its
        # delta_flow tap sees this tensor)
        delta_x = delta_flow[..., 0].float()
        delta = torch.stack([delta_x, torch.zeros_like(delta_x)], -1)
        record_numerics_tap(delta, "delta_flow")
        return net_list, coords1 + delta, mask

    def _train_refine(self, net_list, inp_list, corr_state, coords0,
                      coords1, iters, fused: bool = False, flow_gt=None,
                      loss_mask=None):
        """The training refinement (JAX ``_refine``'s train branches).

        Every iteration computes its upsampling mask. Under
        ``deferred_upsample`` it emits its low-res flow and mask and one
        batched upsample runs after the loop; otherwise each iteration
        upsamples its own. The stacked predictions ``(iters, B, H, W, 1)``
        are returned, or with ``flow_gt``/``loss_mask`` (the fused loss)
        ``(err_sums (iters,), final flow_up (B, H, W, 1))``: each
        iteration's masked L1 sum, reduced in the loop (non-deferred) or
        after it in tile layout, over ``upsample_chunk_count`` chunks.
        ``remat_loss_tail`` recomputes the post-loop tail in the
        backward.

        The iterations run under one of three schedules:
        ``batched_scan_wgrad`` (``ops/scan_grad.py``, the whole loop as one
        ``refinement_scan``); under ``remat_refinement`` each iteration as
        ``refinement_scan(..., length=1, batched=False)``, keeping what
        :func:`resolve_save_kinds` names (nothing: full per-iteration
        recompute, the counterpart of ``nn.remat(RefinementStep)``); or
        with nothing recomputed."""
        cfg = self.cfg
        dt = self.compute_dtype
        n = len(net_list)
        loss = flow_gt is not None
        deferred = cfg.deferred_upsample
        b, h, w = coords0.shape[:3]
        rd = (getattr(torch, cfg.residual_dtype)
              if cfg.residual_dtype is not None else None)
        kinds = resolve_save_kinds(cfg, iters, b, h, w, dt,
                                   fused_lookup=fused)

        # the iteration-invariant tensors, flat: coords0, the context
        # biases, the correlation state, then the loss's gt and mask
        inp_flat = [t for triple in inp_list for t in triple]
        state_t = list(state_tensors(corr_state))
        gt = lm = None
        if loss:
            gt, lm = flow_gt.float(), loss_mask.float()
        bcast = [coords0, *inp_flat, *state_t] + ([gt, lm] if loss else [])
        n_inp, n_state = len(inp_flat), len(state_t)

        def body(tap, coords, nets, bc):
            c0 = bc[0]
            inp = [tuple(bc[1 + 3 * i:4 + 3 * i]) for i in range(n)]
            state = with_tensors(corr_state,
                                 bc[1 + n_inp:1 + n_inp + n_state])
            nets, coords, mask = self._iteration(
                list(nets), inp, state, c0, coords, compute_mask=True,
                fused=fused, tap=tap)
            if deferred:
                return coords, nets, (), ((coords - c0)[..., :1], mask)
            flow_up = upsample_disparity_convex(coords - c0, mask.float(),
                                                cfg.factor)
            if not loss:
                return coords, nets, (), (flow_up,)
            err = torch.abs(flow_up.float() - bc[-2])
            err_sum = torch.where(bc[-1] > 0, err,
                                  torch.zeros((), device=err.device)).sum()
            return coords, nets, (flow_up,), (err_sum,)

        n_extra = int(loss and not deferred)
        params = list(self.update_block.parameters())
        if cfg.batched_scan_wgrad:
            coords1, net_list, extra, ys = refinement_scan(
                body, coords1, net_list, bcast, params, length=iters,
                n_extra=n_extra, save_kinds=kinds, residual_dtype=rd)
        else:
            per_iter = []
            extra = ()
            for _ in range(iters):
                if cfg.remat_refinement:
                    coords1, net_list, extra, y = refinement_scan(
                        body, coords1, net_list, bcast, params, length=1,
                        n_extra=n_extra, save_kinds=kinds,
                        residual_dtype=rd, batched=False)
                    y = [v[0] for v in y]
                else:
                    coords1, net_list, extra, y = body(None, coords1,
                                                       net_list, bcast)
                    net_list = list(net_list)
                per_iter.append(y)
            ys = [torch.stack([y[j] for y in per_iter])
                  for j in range(len(per_iter[0]))]

        if not deferred:
            return (ys[0], extra[0]) if loss else ys[0]
        lowres, masks = ys
        return (self._loss_tail(lowres, masks, gt, lm) if loss
                else self._upsample_tail(lowres, masks))

    def _upsample_tail(self, lowres, masks):
        """The deferred schedule's stacked predictions: one batched convex
        upsample of every iteration, in a checkpoint region under
        ``remat_loss_tail`` (its fp32 softmax intermediates recomputed in
        the backward rather than kept)."""
        factor = self.cfg.factor

        def upsample_stack(lr, mk):
            it, b, h, w = lr.shape[:4]
            tiles = convex_upsample_tiles(
                lr.reshape(it * b, h, w, 1).float(),
                mk.reshape(it * b, h, w, -1).float(), factor)
            up = upsample_tiles_to_image(tiles)
            return up.reshape(it, b, h * factor, w * factor, 1)

        if self.cfg.remat_loss_tail:
            return checkpoint(upsample_stack, lowres, masks,
                              use_reentrant=False)
        return upsample_stack(lowres, masks)

    def _loss_tail(self, lowres, masks, gt, lm):
        """The deferred fused loss: each iteration's masked L1 sum against
        the ground truth in tile layout (the ``(B, H, W)`` gt and mask
        transposed once), over ``upsample_chunk_count`` chunks of
        iterations, each chunk in a checkpoint region under
        ``remat_loss_tail``; and the final iteration's upsampled flow.
        Returns ``(err_sums (iters,), flow_up (B, H, W, 1))``."""
        cfg = self.cfg
        f = cfg.factor
        it, bb, hp, wp = lowres.shape[:4]
        gt_t = image_to_upsample_tiles(gt, f)
        mask_t = image_to_upsample_tiles(lm, f)
        zero = torch.zeros((), device=gt.device)

        def chunk_err(lr_c, mk_c):
            itc = lr_c.shape[0]
            t = convex_upsample_tiles(
                lr_c.reshape(itc * bb, hp, wp, 1).float(),
                mk_c.reshape(itc * bb, hp, wp, -1).float(), f)
            e = torch.abs(t.reshape(itc, bb, hp, wp, f, f) - gt_t[None])
            e = torch.where(mask_t[None] > 0, e, zero)
            return e.sum(dim=(1, 2, 3, 4, 5))

        nch = upsample_chunk_count(it, bb, hp, wp, f,
                                   budget=cfg.upsample_tile_budget)
        itc = it // nch
        sums = []
        for c in range(nch):
            args = (lowres[c * itc:(c + 1) * itc],
                    masks[c * itc:(c + 1) * itc])
            sums.append(checkpoint(chunk_err, *args, use_reentrant=False)
                        if cfg.remat_loss_tail else chunk_err(*args))
        final = upsample_tiles_to_image(convex_upsample_tiles(
            lowres[-1].float(), masks[-1].float(), f))
        return torch.cat(sums), final


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random weights, as the JAX package initializes them: He-normal
    (fan-out) conv kernels and zero biases; norm scales 1, shifts 0."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, nn.Conv2d):
                fan_out = mod.out_channels * mod.kernel_size[0] \
                    * mod.kernel_size[1]
                w = torch.randn(mod.weight.shape, generator=generator,
                                dtype=torch.float32)
                mod.weight.copy_(w * (2.0 / fan_out) ** 0.5)
                mod.bias.zero_()
    return model
