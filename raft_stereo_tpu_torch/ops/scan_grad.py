"""The training refinement's own backward: selective saves and batched
weight gradients (the port of ``raft_stereo_tpu.ops.scan_grad``).

:func:`refinement_scan` runs ``length`` refinement iterations as one
``torch.autograd.Function``:

* the **forward** runs the iterations without autograd and keeps each
  iteration's input carry (the hidden states in ``residual_dtype``, the
  coordinates never narrowed) and the values the save policy names:
  ``"zr"``/``"q"`` (every ConvGRU's gate-conv outputs) and ``"corr"``
  (the looked-up correlation);
* the **backward** walks the iterations in reverse, recomputing each with
  autograd from its saved carry. A saved gate output is replayed without
  its conv (the input's gradient still flows, :class:`_ReplayConv`); a
  saved correlation is replayed without the lookup's forward while the
  lookup's backward (its kernel) still writes the volume's or the
  features' gradient (``ops/corr.py::corr_lookup_replay``). The data
  gradients accumulate for the carry, for the parameters of the update
  block and for the broadcasts (the correlation state, which feeds the
  encoders, and the context biases).

With ``batched=True`` (``config.batched_scan_wgrad``) the gate convs'
weights are detached in that reverse loop and a zeros ``eps`` is added to
each gate site's output: its gradient is the site's output cotangent, and
no primal value changes. Each site's ``(input, cotangent)`` pairs are
stacked over the iterations, and after the loop one contraction a site
computes its weight gradient over the ``(iters*B)``-merged stacks
(``nn/layers.py::Conv.weight_grad``: the route the conv's own backward
takes, ``aten.convolution_backward``; a library call, as JAX's
``conv_general_dilated`` wgrad is), summed over the slow-fast applications
that share the weights (the ``pre32``/``pre16``/``main`` scopes). The
z and r gates are two modules here (JAX has one fused zr conv): their
weight gradient is ONE contraction over the concatenated cotangent,
split after. The contraction has fp32 sums and an fp32 output, as JAX's
``preferred_element_type=float32`` does (bf16 stacks are widened to fp32,
whose products of bf16 values are exact, in TF32 too); its iterations
are the groups of one grouped convolution, so that each fp32 sum runs
over one iteration's terms and the iterations' partials are summed
after (one sum over all of them drifted on the card).

With ``batched=False`` and ``length=1`` it is one iteration of the
per-iteration recompute schedule (``remat_refinement``, the counterpart of
JAX's ``nn.remat(RefinementStep)``), keeping what the save policy names
(``refinement_save_policy``; nothing: the whole iteration recomputed): the
gate weights keep their per-iteration gradients, and ``residual_dtype``
rounds each kept value through that dtype in the forward (JAX's
cast-through ``tag_residual``, its cotangent rounded alike); the carry is
kept as it is.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, FrozenSet, List, Optional, Sequence

import torch

from raft_stereo_tpu_torch.ops.corr import corr_lookup, corr_lookup_replay


def gate_conv(convs, x: torch.Tensor, detach: bool = False) -> torch.Tensor:
    """``convs``' outputs on ``x`` (NHWC), concatenated along channels:
    the values of calling each module. ``detach``: with detached
    weights."""
    outs = []
    for conv in convs:
        w, b = conv.weight, conv.bias
        if detach:
            w, b = w.detach(), b.detach()
        dt = conv.compute_dtype
        outs.append(conv.conv_with(x, w.to(dt), b.to(dt)))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=-1)


class _ReplayConv(torch.autograd.Function):
    """A saved gate output in place of ``gate_conv(convs, x)``: the
    forward returns ``saved`` (in the compute dtype); the backward gives
    ``x``'s gradient through the convs' transposes and, unless the weight
    gradients are deferred, the weights' and biases' (the compute-dtype
    copies' given as inputs), each conv's by the call autograd makes for
    it. ``through``: the value was rounded through that dtype in the
    forward, so the cotangent is too."""

    @staticmethod
    def forward(ctx, spec, x, saved, *wb):
        ctx.spec = spec
        ctx.save_for_backward(x, *wb)
        return saved.to(spec[0][0].compute_dtype, copy=True)

    @staticmethod
    def backward(ctx, g):
        convs, through = ctx.spec
        x, *wb = ctx.saved_tensors
        if through is not None:
            g = g.to(through).to(g.dtype)
        need = ctx.needs_input_grad
        need_w = any(need[3:])
        # each conv's backward as autograd runs it on that conv's own
        # output (a contiguous cotangent): the same numbers
        dx, dwb, off = None, [], 0
        for conv, w in zip(convs, wb[0::2]):
            g_i = g[..., off:off + conv.out_channels].contiguous()
            off += conv.out_channels
            dx_i, dw, db = conv.conv_backward(x, w, g_i,
                                              (need[1], need_w, need_w))
            dx = dx_i if dx is None else dx + dx_i
            dwb += [dw, db]
        return (None, dx, None, *dwb)


class _Scoped:
    """A tap seen from one application of the update block: site keys
    gain the application's prefix (the slow-fast pre-iterations re-run
    GRUs on the same weights)."""

    def __init__(self, tap, prefix: str):
        self._tap, self._prefix = tap, prefix

    def gate_conv(self, site: str, kind: str, convs, x):
        return self._tap.gate_conv(f"{self._prefix}/{site}/{kind}", kind,
                                   convs, x)


class _Tap:
    def scoped(self, prefix: str) -> _Scoped:
        return _Scoped(self, prefix)


class SaveTap(_Tap):
    """The forward's tap: every site computed as usual; the values of the
    ``save_kinds`` kept in ``saves`` (in ``save_dtype``; ``cast_through``:
    the forward goes on from the rounded value)."""

    def __init__(self, save_kinds: FrozenSet[str],
                 save_dtype: Optional[torch.dtype], cast_through: bool):
        self.save_kinds, self.save_dtype = save_kinds, save_dtype
        self.cast_through = cast_through
        self.saves: Dict[str, torch.Tensor] = {}

    def _keep(self, key, kind, value):
        if kind not in self.save_kinds:
            return value
        sd = self.save_dtype
        if sd is None or value.dtype == sd:
            self.saves[key] = value
            return value
        self.saves[key] = kept = value.to(sd)
        return kept.to(value.dtype) if self.cast_through else value

    def gate_conv(self, key, kind, convs, x):
        return self._keep(key, kind, gate_conv(convs, x))

    def corr_site(self, corr_state, coords, dtype):
        return self._keep("corr", "corr",
                          corr_lookup(corr_state, coords).to(dtype))


class ReplayTap(_Tap):
    """The backward's tap: saved values replayed (``through``: their
    cotangents rounded through that dtype, as their values were), the
    other sites recomputed. ``defer``: the gate weights detached, an
    ``eps`` on every gate output, and the sites' inputs kept in
    ``inputs``."""

    def __init__(self, replay: Dict[str, torch.Tensor], defer: bool,
                 through: Optional[torch.dtype]):
        self.replay, self.defer, self.through = replay, defer, through
        self.inputs: Dict[str, tuple] = {}
        self.eps: Dict[str, torch.Tensor] = {}

    def gate_conv(self, key, kind, convs, x):
        saved = self.replay.get(key)
        if saved is None:
            out = gate_conv(convs, x, detach=self.defer)
        else:
            wb = []
            for conv in convs:
                w, b = conv.weight, conv.bias
                if self.defer:
                    w, b = w.detach(), b.detach()
                dt = conv.compute_dtype
                wb += [w.to(dt), b.to(dt)]
            out = _ReplayConv.apply((tuple(convs), self.through), x, saved,
                                    *wb)
        if self.defer:
            self.inputs[key] = (tuple(convs), x)
            self.eps[key] = eps = torch.zeros_like(out, requires_grad=True)
            out = out + eps
        return out

    def corr_site(self, corr_state, coords, dtype):
        saved = self.replay.get("corr")
        if saved is None:
            return corr_lookup(corr_state, coords).to(dtype)
        return corr_lookup_replay(corr_state, coords, saved, dtype,
                                  self.through)


@dataclasses.dataclass
class _Spec:
    body: Callable
    n_nets: int
    n_extra: int
    n_bcast: int
    params: List[torch.nn.Parameter]
    length: int
    save_kinds: FrozenSet[str]
    residual_dtype: Optional[torch.dtype]
    batched: bool


class _Refinement(torch.autograd.Function):
    """``apply(spec, coords, *nets, *bcast, *params)`` -> ``(coords,
    *nets, *extra, *ys)``: the final carry and each per-iteration output
    stacked over the iterations (module docstring)."""

    @staticmethod
    def forward(ctx, spec: _Spec, coords, *rest):
        n, nb = spec.n_nets, spec.n_bcast
        nets, bcast = list(rest[:n]), rest[n:n + nb]
        carry_dt = spec.residual_dtype if spec.batched else None
        tensors, keys, ys = [], [], []
        extra = ()
        for _ in range(spec.length):
            tensors += [coords] + [
                h if carry_dt is None or h.dtype == carry_dt
                else h.to(carry_dt) for h in nets]
            tap = (SaveTap(spec.save_kinds, spec.residual_dtype,
                           cast_through=not spec.batched)
                   if spec.save_kinds else None)
            coords, nets, extra, y = spec.body(tap, coords, nets, bcast)
            nets = list(nets)
            saves = tap.saves if tap is not None else {}
            keys.append(tuple(saves))
            tensors += list(saves.values())
            ys.append(y)
        ctx.spec, ctx.keys = spec, keys
        ctx.net_dtypes = [h.dtype for h in rest[:n]]
        ctx.save_for_backward(*bcast, *tensors)
        ctx.set_materialize_grads(False)
        stacked = [torch.stack([y[j] for y in ys])
                   for j in range(len(ys[0]))]
        return (coords, *nets, *extra, *stacked)

    @staticmethod
    def backward(ctx, d_coords, *grads):
        spec = ctx.spec
        n, ne, nb = spec.n_nets, spec.n_extra, spec.n_bcast
        d_nets = list(grads[:n])
        d_extra = grads[n:n + ne]
        d_ys = grads[n + ne:]
        saved = ctx.saved_tensors
        bcast = [b.detach().requires_grad_(need) for b, need in zip(
            saved[:nb], ctx.needs_input_grad[2 + n:2 + n + nb])]
        params = spec.params
        p_need = [i for i, need in enumerate(
            ctx.needs_input_grad[2 + n + nb:]) if need]
        b_need = [i for i, b in enumerate(bcast) if b.requires_grad]
        d_bcast: List[Optional[torch.Tensor]] = [None] * nb
        d_params: List[Optional[torch.Tensor]] = [None] * len(params)
        # per iteration: the carry (coords + nets), then its saves
        records, pos = [], nb
        for keys in ctx.keys:
            carry = saved[pos:pos + 1 + n]
            pos += 1 + n
            records.append((carry, dict(zip(keys, saved[pos:pos
                                                        + len(keys)]))))
            pos += len(keys)
        through = None if spec.batched else spec.residual_dtype
        stacks: Dict[str, list] = {}
        last = spec.length - 1
        for t in reversed(range(spec.length)):
            (coords, *nets), replay = records[t]
            nets = [h.detach().to(dt).requires_grad_(True)
                    for h, dt in zip(nets, ctx.net_dtypes)]
            tap = ReplayTap(replay, spec.batched, through)
            with torch.enable_grad():
                coords2, nets2, extra2, y = spec.body(tap, coords, nets,
                                                      bcast)
            outs, gouts = [], []
            pairs = list(zip(nets2, d_nets)) + [
                (y_j, None if d is None else d[t]) for y_j, d in zip(y, d_ys)]
            if t == last:
                pairs += [(coords2, d_coords)] + list(zip(extra2, d_extra))
            for o, g in pairs:
                if g is not None and o.requires_grad:
                    outs.append(o)
                    gouts.append(g)
            keys = list(tap.eps)
            inputs = (nets + [bcast[i] for i in b_need]
                      + [params[i] for i in p_need]
                      + [tap.eps[k] for k in keys])
            got = (torch.autograd.grad(outs, inputs, gouts,
                                       allow_unused=True)
                   if outs else (None,) * len(inputs))
            d_nets = list(got[:n])
            off = n
            for i in b_need:
                d_bcast[i] = _add(d_bcast[i], got[off])
                off += 1
            for i in p_need:
                d_params[i] = _add(d_params[i], got[off])
                off += 1
            for key, g in zip(keys, got[off:]):
                convs, x = tap.inputs[key]
                if g is None:
                    g = torch.zeros_like(tap.eps[key])
                _stack_into(stacks, key, convs, x, g, t, spec)
        if stacks:
            _batched_wgrads(stacks, params, d_params)
        return (None, None, *d_nets, *d_bcast, *d_params)


def _add(acc, g):
    if g is None:
        return acc
    return g if acc is None else acc + g


def _stack_into(stacks, key, convs, x, g, t, spec):
    """Write iteration ``t``'s input ``x`` (as the conv reads it, in the
    compute dtype) and output cotangent ``g`` of a gate site into its
    stacks (made at its first visit, the last iteration), in
    ``residual_dtype`` where set."""
    rd = spec.residual_dtype
    if key not in stacks:
        stacks[key] = [convs] + [
            torch.empty((spec.length,) + tuple(v.shape),
                        dtype=rd or g.dtype, device=v.device)
            for v in (x, g)]
    _, xs, gs = stacks[key]
    xs[t].copy_(x.detach())
    gs[t].copy_(g)


def _batched_wgrads(stacks, params, d_params):
    """One weight-gradient contraction a gate site over its (iters*B)
    stacks (the iterations its groups), its bias gradient summed in fp32,
    both added (over the scopes that share the convs) to ``d_params``."""
    index = {id(p): i for i, p in enumerate(params)}
    for key, (convs, xs, gs) in stacks.items():
        x = xs.reshape((-1,) + tuple(xs.shape[2:]))
        g = gs.reshape((-1,) + tuple(gs.shape[2:]))
        dw = convs[0].weight_grad(x, g, groups=xs.shape[0])
        db = g.sum(dim=(0, 1, 2), dtype=torch.float32)
        sizes = [c.out_channels for c in convs]
        for conv, dwi, dbi in zip(convs, dw.split(sizes), db.split(sizes)):
            for p, grad in ((conv.weight, dwi), (conv.bias, dbi)):
                i = index[id(p)]
                d_params[i] = _add(d_params[i], grad.to(p.dtype))


def refinement_scan(body: Callable, coords: torch.Tensor,
                    nets: Sequence[torch.Tensor],
                    bcast: Sequence[torch.Tensor],
                    params: Sequence[torch.nn.Parameter], *, length: int,
                    n_extra: int = 0,
                    save_kinds: FrozenSet[str] = frozenset(),
                    residual_dtype: Optional[torch.dtype] = None,
                    batched: bool = True):
    """Run ``length`` refinement iterations with the backward of the
    module docstring.

    ``body(tap, coords, nets, bcast) -> (coords, nets, extra, ys)`` is one
    iteration: ``tap`` (a :class:`SaveTap`, a :class:`ReplayTap` or None)
    goes to the update block's gate sites and the lookup; ``extra`` are
    ``n_extra`` carry entries the next iteration does not read (the
    in-loop fused loss's ``flow_up``); ``ys`` the per-iteration outputs.
    ``bcast`` are the iteration-invariant tensors (the correlation state,
    the context biases, ``coords0``, the loss's ground truth and mask)
    and ``params`` every parameter ``body`` uses (the update block's).
    ``save_kinds`` is a subset of ``{"zr", "q", "corr"}``.

    Returns ``(coords, nets, extra, ys)``: the final carry and each entry
    of ``ys`` stacked over the iterations."""
    spec = _Spec(body, len(nets), n_extra, len(bcast), list(params),
                 length, frozenset(save_kinds), residual_dtype, batched)
    out = _Refinement.apply(spec, coords, *nets, *bcast, *params)
    n = len(nets)
    return (out[0], list(out[1:1 + n]), out[1 + n:1 + n + n_extra],
            out[1 + n + n_extra:])
