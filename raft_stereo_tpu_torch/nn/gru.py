"""Recurrent refinement cell (the port of ``raft_stereo_tpu.nn.gru``).

A coarse-to-fine stack of ConvGRUs with cross-resolution links (pool down,
bilinear up), a motion encoder that turns correlation + flow into 128-d
features, the flow head and the upsampling-mask head. The context biases
``cz, cr, cq`` are computed once outside the loop and added per gate.
The math is upstream's: one conv over the concatenated inputs, where the
JAX package splits its gate convs by input.

The numerics tap sink: :func:`numerics_taps` arms a module-level dict
around a forward; while it is armed, every :func:`record_numerics_tap`
call deposits one ``(6,)`` statistics vector (obs/numerics.py's
``STAT_FIELDS``) under ``"NN:label"``, NN the trace order. Unarmed (the
default) a recording call does nothing and the forward runs the same ops.
The sites are the JAX package's: each ConvGRU's gate pre-activations
(``"gru32.zr"``, ``"gru32.q"``, ...), the looked-up correlation
(``"corr_feats"``) and the flow head's output (``"delta_flow"``,
models/raft_stereo.py).
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from raft_stereo_tpu_torch.config import RAFTStereoConfig
from raft_stereo_tpu_torch.nn.layers import Conv
from raft_stereo_tpu_torch.obs.numerics import (BF16_MAX_FINITE,
                                                BF16_MIN_NORMAL)
from raft_stereo_tpu_torch.ops.geometry import (pool2x,
                                                resize_bilinear_align_corners)
from raft_stereo_tpu_torch.ops.kernels.fused_lookup import fused_lookup_c1


# the armed sink: None (unarmed) or the dict the recording calls fill
_tap_sink = None

#: fp32 bit pattern of the smallest normal bf16: the underflow rail
_BF16_MIN_BITS = int(torch.tensor(BF16_MIN_NORMAL, dtype=torch.float32)
                     .view(torch.int32))
#: fp32 bit pattern of +inf: magnitudes at or above it are not finite
_F32_INF_BITS = 0x7F800000


def _tap_stats(x: torch.Tensor) -> torch.Tensor:
    """``[min, max, absmean, nonfinite, sat, underflow]`` of ``x`` as one
    fp32 ``(6,)`` tensor on its device, enqueued without a host sync. min,
    max and absmean are over the finite values (an all-NaN tensor gives
    the +/-inf sentinels); absmean divides by every element. ``sat``
    counts ``|x| >= BF16_MAX_FINITE``; ``underflow`` counts nonzero
    magnitudes below bf16's smallest normal, compared on the raw fp32 bit
    pattern. The magnitude's bits (sign cleared) give ``|x|`` and the
    finiteness test alike."""
    x32 = x.float()
    mag = x32.view(torch.int32) & 0x7FFFFFFF
    finite = mag < _F32_INF_BITS
    absx = mag.view(torch.float32)
    f32 = torch.float32
    return torch.stack([
        torch.where(finite, x32, float("inf")).amin(),
        torch.where(finite, x32, float("-inf")).amax(),
        torch.where(finite, absx, 0.0).mean(),
        (~finite).sum(dtype=f32),
        (absx >= BF16_MAX_FINITE).sum(dtype=f32),
        ((mag != 0) & (mag < _BF16_MIN_BITS)).sum(dtype=f32)])


@contextlib.contextmanager
def numerics_taps():
    """Arm the tap sink for one forward (or one iteration); yields the
    dict the recording calls fill. Re-entrant: the previous sink is
    restored on exit."""
    global _tap_sink
    prev = _tap_sink
    _tap_sink = {}
    try:
        yield _tap_sink
    finally:
        _tap_sink = prev


def record_numerics_tap(x: torch.Tensor, label: str) -> torch.Tensor:
    """Deposit ``x``'s statistics in the armed sink under
    ``"NN:label"``; a label recorded again in one arming (the slow-fast
    pre-iterations re-run a GRU) becomes ``label#2``, ``label#3``.
    Returns ``x``; does nothing when no sink is armed."""
    if _tap_sink is None:
        return x
    base, n = label, 2
    while any(k.partition(":")[2] == label for k in _tap_sink):
        label = f"{base}#{n}"
        n += 1
    _tap_sink[f"{len(_tap_sink):02d}:{label}"] = _tap_stats(x)
    return x


def taps_armed() -> bool:
    """Whether a tap sink is armed."""
    return _tap_sink is not None


class FlowHead(nn.Module):
    """Two 3x3 convs (256 hidden channels) -> delta flow ``(B, h, w, 2)``."""

    def __init__(self, input_dim: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv1 = Conv(input_dim, 256, 3, 1, 1, dtype)
        self.conv2 = Conv(256, 2, 3, 1, 1, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(F.relu(self.conv1(x)))


class ConvGRU(nn.Module):
    """3x3 convolutional GRU with additive per-gate context biases.

    ``site`` leads its numerics tap labels (``"gru32.zr"``, ``.q``): the
    gate pre-activations with the conv bias, before the context biases;
    ``zr`` is the z and r convs' outputs together, as the JAX package
    computes them in one conv.

    ``tap`` (the training refinement's, ``ops/scan_grad.py``) computes the
    two gate sites instead: ``"zr"`` (``convz`` and ``convr`` of ``[h,
    x]``, their outputs concatenated) and ``"q"`` (``convq`` of ``[r*h,
    x]``), with the same values."""

    def __init__(self, hidden_dim: int, input_dim: int,
                 dtype: Optional[torch.dtype] = None, site: str = "gru"):
        super().__init__()
        c = hidden_dim + input_dim
        self.site = site
        self.convz = Conv(c, hidden_dim, 3, 1, 1, dtype)
        self.convr = Conv(c, hidden_dim, 3, 1, 1, dtype)
        self.convq = Conv(c, hidden_dim, 3, 1, 1, dtype)

    def forward(self, h, cz, cr, cq, *x_list, tap=None):
        x = torch.cat(x_list, dim=-1)
        hx = torch.cat([h, x], dim=-1)
        if tap is None:
            z, r = self.convz(hx), self.convr(hx)
        else:
            z, r = tap.gate_conv(self.site, "zr", (self.convz, self.convr),
                                 hx).chunk(2, dim=-1)
        if taps_armed():
            record_numerics_tap(torch.cat([z, r], dim=-1),
                                f"{self.site}.zr")
        z = torch.sigmoid(z + cz)
        r = torch.sigmoid(r + cr)
        rhx = torch.cat([r * h, x], dim=-1)
        q = (self.convq(rhx) if tap is None
             else tap.gate_conv(self.site, "q", (self.convq,), rhx))
        record_numerics_tap(q, f"{self.site}.q")
        q = torch.tanh(q + cq)
        return (1 - z) * h + z * q


class BasicMotionEncoder(nn.Module):
    """Correlation + flow -> 128-d motion features (126 + the 2 flow
    channels passed through).

    Given the correlation state and the lookup centers instead of ``corr``
    (the ``fused_lookup`` path), the pyramid lookup, ``convc1`` and its
    ReLU run as one fused kernel (``ops/kernels/fused_lookup.py``) on the
    same parameters; no corr tensor exists."""

    def __init__(self, cfg: RAFTStereoConfig,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.convc1 = Conv(cfg.corr_channels, 64, 1, 1, 0, dtype)
        self.convc2 = Conv(64, 64, 3, 1, 1, dtype)
        self.convf1 = Conv(2, 64, 7, 1, 3, dtype)
        self.convf2 = Conv(64, 64, 3, 1, 1, dtype)
        self.conv = Conv(128, 128 - 2, 3, 1, 1, dtype)

    def forward(self, flow: torch.Tensor, corr: Optional[torch.Tensor],
                corr_state=None, coords_x: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        if corr_state is not None:
            w = self.convc1.weight
            cor = fused_lookup_c1(corr_state.levels, coords_x,
                                  w.view(w.shape[0], -1).t(),
                                  self.convc1.bias, corr_state.radius,
                                  self.convc1.compute_dtype)
        else:
            cor = F.relu(self.convc1(corr))
        cor = F.relu(self.convc2(cor))
        flo = F.relu(self.convf2(F.relu(self.convf1(flow))))
        out = F.relu(self.conv(torch.cat([cor, flo], dim=-1)))
        return torch.cat([out, flow], dim=-1)


def interp_to(x: torch.Tensor, dest: torch.Tensor) -> torch.Tensor:
    """Bilinear align-corners resize of ``x`` to ``dest``'s spatial shape."""
    return resize_bilinear_align_corners(x, (dest.shape[1], dest.shape[2]))


class BasicMultiUpdateBlock(nn.Module):
    """Coarse-to-fine GRU refinement cell with 1-3 levels.

    ``net`` is the hidden-state list ordered fine->coarse; ``inp`` holds the
    per-level ``(cz, cr, cq)`` context biases. ``iter08/16/32`` select which
    levels update in this call; ``update=False`` runs the GRUs only (the
    slow_fast_gru pre-iterations); ``compute_mask=False`` skips the mask
    head (inference needs only the final iteration's mask). ``corr_state``
    and ``coords_x`` replace ``corr`` on the fused-lookup path. ``tap``
    goes to every ConvGRU (their gate-conv sites, ``ops/scan_grad.py``).
    """

    def __init__(self, cfg: RAFTStereoConfig,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.cfg = cfg
        hd = cfg.hidden_dims
        n = cfg.n_gru_layers
        self.encoder = BasicMotionEncoder(cfg, dtype)
        self.gru08 = ConvGRU(hd[2], 128 + hd[1] * (n > 1), dtype=dtype,
                             site="gru08")
        if n >= 2:
            self.gru16 = ConvGRU(hd[1], hd[0] * (n == 3) + hd[2],
                                 dtype=dtype, site="gru16")
        if n == 3:
            self.gru32 = ConvGRU(hd[0], hd[1], dtype=dtype, site="gru32")
        self.flow_head = FlowHead(hd[2], dtype)
        self.mask = nn.Sequential(
            Conv(hd[2], 256, 3, 1, 1, dtype), nn.ReLU(),
            Conv(256, cfg.factor ** 2 * 9, 1, 1, 0, dtype))

    def forward(self, net: Sequence[torch.Tensor], inp, corr=None, flow=None,
                iter08: bool = True, iter16: bool = True, iter32: bool = True,
                update: bool = True, compute_mask: bool = True,
                corr_state=None, coords_x=None, tap=None):
        n = self.cfg.n_gru_layers
        net = list(net)
        if iter32:
            net[2] = self.gru32(net[2], *inp[2], pool2x(net[1]), tap=tap)
        if iter16:
            if n > 2:
                net[1] = self.gru16(net[1], *inp[1], pool2x(net[0]),
                                    interp_to(net[2], net[1]), tap=tap)
            else:
                net[1] = self.gru16(net[1], *inp[1], pool2x(net[0]),
                                    tap=tap)
        if iter08:
            motion = self.encoder(flow, corr, corr_state, coords_x)
            if n > 1:
                net[0] = self.gru08(net[0], *inp[0], motion,
                                    interp_to(net[1], net[0]), tap=tap)
            else:
                net[0] = self.gru08(net[0], *inp[0], motion, tap=tap)

        if not update:
            return net
        delta_flow = self.flow_head(net[0])
        if not compute_mask:
            return net, None, delta_flow
        # scale the mask to balance gradients, as upstream
        return net, 0.25 * self.mask(net[0]), delta_flow
