"""Shape-bucketed program cache for the serving scheduler (the port of
``raft_stereo_tpu/serve/cache.py``).

One entry serves one :class:`BucketKey`: padded bucket ``(H, W)`` × batch
size × refinement iterations × warm-start flavour × correlation
implementation. Its program is the model's test-mode forward plus the
per-request guard: a ``(B,)`` finiteness flag over each sample's output,
computed on the device beside the outputs, so a poisoned request fails
alone. The low-res flow comes back too (a video session's next
``flow_init``), with ``converge`` the per-sample residual curves
``(iters, B)``, on the adaptive flavour (a bucket an iteration policy
covers, ``BucketKey.policy`` its digest) the per-sample ``iters_taken``,
and with ``numerics`` the tap statistics, last.

Where the JAX package compiles an executable per key, the port keeps a
module per correlation implementation: an entry whose ``impl`` differs
from the config's runs a second ``RAFTStereo`` that shares the first one's
parameter and buffer tensors, so a reload reaches every flavour at once.
``warmup`` with ``aot=True`` runs one forward per key on zeros before
traffic is admitted: it builds the kernels, lets cuDNN choose its
algorithms, makes the calling thread's cuDNN and cuBLAS handles and grows
the device and pinned-host allocators (the port's counterpart of
``lower().compile()``); ``aot=False`` runs nothing before first use.

A call enqueues the forward and returns a :class:`Dispatch` at once. On the
card each output is copied into a pinned host buffer that the dispatch
owns, without blocking, and an event is recorded after the copies, so the
scheduler keeps a window of dispatches in flight; a device fault shows up
when the dispatch is retired. On the CPU the forward runs inline.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from raft_stereo_tpu_torch.config import RAFTStereoConfig
from raft_stereo_tpu_torch.inference import (PAD_DIVIS, host_copy,
                                             host_numpy, resolve_device,
                                             stage)
from raft_stereo_tpu_torch.models.raft_stereo import RAFTStereo
from raft_stereo_tpu_torch.obs.converge import (load_policy, policy_digest,
                                                policy_lookup)
from raft_stereo_tpu_torch.ops.geometry import InputPadder
from raft_stereo_tpu_torch.training.resilience import tree_structure_hash


class BucketKey(NamedTuple):
    """Identity of one served program."""

    height: int   # padded (bucket) height
    width: int    # padded (bucket) width
    batch: int
    iters: int
    warm: bool    # True = the flavour with a flow_init input
    #: iteration-policy digest (obs/converge.py ``policy_digest``) of the
    #: early-exit flavour; "" is the fixed-trip forward. Part of the key,
    #: so another policy never reuses an entry made for this one
    policy: str = ""
    #: correlation implementation of the program; "" is the server
    #: config's own (e.g. "fused" for buckets past --fused_width)
    impl: str = ""

    def label(self) -> str:
        return (f"{self.height}x{self.width}b{self.batch}i{self.iters}"
                f"{'w' if self.warm else ''}"
                f"{'@' + self.policy if self.policy else ''}"
                f"{'+' + self.impl if self.impl else ''}")


def padded_batch(images: Sequence[np.ndarray], target: Tuple[int, int],
                 device: torch.device):
    """HWC images of one bucket -> ``(batch (B, H, W, C) on device, their
    padders, the staged host tensors)``. Each image is staged and padded as
    ``StereoPredictor`` stages and pads a batch of one, and the batch is
    concatenated channels-first, so a batch of one is the predictor's
    input tensor, values and strides alike."""
    padded, padders, staged = [], [], []
    for image in images:
        tensor, host = stage(np.asarray(image)[None], device)
        padder = InputPadder(tensor.shape, divis_by=PAD_DIVIS, target=target)
        padded.append(padder.pad(tensor).permute(0, 3, 1, 2))
        padders.append(padder)
        staged.append(host)
    return torch.cat(padded).permute(0, 2, 3, 1), padders, staged


class Dispatch:
    """One enqueued bucket forward. :meth:`result` blocks until it has
    finished and returns its outputs as numpy: ``(flow_lowres, flow_up,
    finite[, deltas][, iters_taken][, taps])``, ``taps`` a dict of
    ``(iters, 6)`` arrays. A device error of the asynchronous forward is
    raised there, once captured, on this and every later call; the
    buffers are released either way."""

    def __init__(self, host: Tuple[torch.Tensor, ...],
                 done: Optional["torch.cuda.Event"], keep: tuple = ()):
        self._host = host
        self._done = done
        # the device outputs and staged inputs stay referenced until the
        # dispatch retires: no buffer is reused while the card reads it
        self._keep = keep
        self._result: Optional[Tuple[np.ndarray, ...]] = None
        self._error: Optional[BaseException] = None

    def ready(self) -> bool:
        if self._result is not None:
            return True
        if self._error is not None:
            return False
        try:
            return self._done is None or self._done.query()
        except RuntimeError:
            return False

    def result(self) -> Tuple[np.ndarray, ...]:
        if self._error is not None:
            raise self._error
        if self._result is None:
            try:
                if self._done is not None:
                    self._done.synchronize()
                self._result = tuple(host_numpy(h) for h in self._host)
            except Exception as exc:
                self._error = exc
                raise
            finally:
                self._host, self._keep = (), ()
        return self._result


class ExecutableCache:
    """BucketKey -> the served test-mode forward, on one device.

    ``state_dict`` holds the port's weights (loaded ``strict=True``).
    ``converge`` serves the convergence flavour: each dispatch also
    returns the per-sample residual curves (``iter_metrics="per_sample"``).
    ``iter_policy`` (a path or a loaded doc; loading lints it, so a
    doctored policy fails here) backs the adaptive flavour, on iff a
    policy is given unless ``adaptive`` says otherwise (False serves the
    fixed forwards with a policy loaded); it implies ``converge``.
    ``numerics`` adds the tap statistics; it does not combine with the
    adaptive flavour, as in the JAX package.
    """

    def __init__(self, cfg: RAFTStereoConfig,
                 state_dict: Dict[str, torch.Tensor], *, device=None,
                 aot: bool = True, converge: bool = False,
                 numerics: bool = False, iter_policy=None,
                 adaptive: Optional[bool] = None):
        self.policy = None
        self.policy_digest: str = ""
        if iter_policy is not None:
            self.policy = (load_policy(iter_policy)
                           if isinstance(iter_policy, str) else iter_policy)
            self.policy_digest = policy_digest(self.policy)
        self.adaptive = (bool(adaptive) if adaptive is not None
                         else self.policy is not None)
        if self.adaptive and self.policy is None:
            raise ValueError("adaptive serving needs an iter_policy "
                             "(python -m raft_stereo_tpu_torch.obs.converge "
                             "--emit-policy)")
        if self.adaptive and numerics:
            raise ValueError("the adaptive flavour carries no numerics "
                             "taps (models/raft_stereo.py); serve "
                             "--numerics needs --adaptive off")
        self.converge = converge or self.adaptive
        self.numerics = numerics
        self.cfg = cfg
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            # the scheduler thread selects the card by index
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.aot = aot
        self.model = RAFTStereo(cfg)
        self.model.load_state_dict(state_dict, strict=True)
        self.model.to(self.device).eval()
        self._modules: Dict[str, RAFTStereo] = {
            cfg.corr_implementation: self.model}
        self._tree_hash = tree_structure_hash(state_dict)
        self._lock = threading.Lock()
        self._entries: Dict[BucketKey, RAFTStereo] = {}

    def check_structure(self, state_dict: Dict[str, torch.Tensor]) -> None:
        """Raise unless ``state_dict`` has the served weights' structure
        (every key, shape and dtype): another structure is another model,
        a new server, not a reload."""
        new_hash = tree_structure_hash(state_dict)
        if new_hash != self._tree_hash:
            raise ValueError(
                f"reload weights have structure hash {new_hash}, the served "
                f"ones {self._tree_hash}: a structural change needs a new "
                "server, not a hot reload")

    def reload(self, state_dict: Dict[str, torch.Tensor]) -> None:
        """Copy new weights into the served tensors in place (every
        flavour's module shares them). On the card the copies are ordered
        after the forwards already enqueued on the stream, so those finish
        on the old weights."""
        self.check_structure(state_dict)
        with self._lock:
            self.model.load_state_dict(state_dict, strict=True)

    # --- entries -------------------------------------------------------------

    def bucket_entry(self, height: int, width: int) -> Optional[Dict]:
        """The policy entry of a padded bucket (``{"tau", "budget",
        "min_iters", ...}``), or None when adaptive is off or the policy
        covers neither the bucket nor a default."""
        if not self.adaptive:
            return None
        return policy_lookup(self.policy, f"{height}x{width}")

    def _module(self, impl: str) -> RAFTStereo:
        impl = impl or self.cfg.corr_implementation
        module = self._modules.get(impl)
        if module is None:
            # an impl-flavoured bucket: the same weights (the correlation
            # touches no parameter), another lookup
            module = RAFTStereo(dataclasses.replace(
                self.cfg, corr_implementation=impl))
            module.load_state_dict(self.model.state_dict(keep_vars=True),
                                   strict=True, assign=True)
            module.eval()
            self._modules[impl] = module
        return module

    def get(self, key: BucketKey) -> RAFTStereo:
        """The module that serves ``key`` (an entry is made on a miss)."""
        if key.policy and (key.policy != self.policy_digest or
                           self.bucket_entry(key.height, key.width) is None):
            raise ValueError(
                f"bucket key {key.label()} names policy {key.policy} but "
                f"the loaded policy (digest {self.policy_digest or None}) "
                f"does not cover {key.height}x{key.width}")
        with self._lock:
            module = self._entries.get(key)
            if module is None:
                module = self._entries[key] = self._module(key.impl)
        return module

    def warmup(self, keys) -> int:
        """Make the entries of ``keys``; with ``aot`` run each new one once
        on zeros at its shape and wait for it (in the calling thread: the
        server calls it from its scheduler thread). Returns the number of
        new entries."""
        fresh = 0
        for key in keys:
            with self._lock:
                have = key in self._entries
            if have:
                continue
            self.get(key)
            fresh += 1
            if self.aot:
                # host arrays: staged through pinned memory as a request's
                # images are, so the host allocator is warm too
                zeros = np.zeros((key.batch, key.height, key.width, 3),
                                 np.float32)
                init = None
                if key.warm:
                    f = self.cfg.factor
                    init = np.zeros((key.batch, key.height // f,
                                     key.width // f, 2), np.float32)
                self(key, zeros, zeros, init).result()
        return fresh

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    # --- invocation ----------------------------------------------------------

    def __call__(self, key: BucketKey, im1, im2, flow_init=None,
                 keep: tuple = ()) -> Dispatch:
        """Enqueue ``key``'s forward on the padded batch ``im1``/``im2``
        (tensors on the device, or arrays that are staged there) with the
        current weights. ``flow_init`` (the warm flavour's low-res
        ``(B, H/f, W/f, 2)`` field) is an array or a tensor on the device;
        ``keep`` holds what must live until the dispatch retires."""
        if key.warm and flow_init is None:
            raise ValueError("a warm bucket needs a flow_init batch")
        module = self.get(key)
        keep = list(keep)
        if not isinstance(im1, torch.Tensor):
            (im1, h1), (im2, h2) = (stage(im1, self.device),
                                    stage(im2, self.device))
            keep += [h1, h2]
        if flow_init is not None and not isinstance(flow_init, torch.Tensor):
            flow_init, h3 = stage(flow_init, self.device)
            keep.append(h3)
        kw = {"iter_metrics": "per_sample" if self.converge else False}
        if key.policy:
            entry = self.bucket_entry(key.height, key.width)
            kw.update(adaptive_tau=float(entry["tau"]),
                      adaptive_min_iters=int(entry["min_iters"]))
        elif self.numerics:
            kw["numerics"] = True
        with torch.inference_mode():
            out = module(im1, im2, iters=key.iters, flow_init=flow_init,
                         test_mode=True, **kw)
            flow_lr, flow_up = out[0], out[1]
            finite = torch.isfinite(flow_up).flatten(1).all(dim=1)
            outputs = (flow_lr, flow_up, finite) + tuple(out[2:])
            cuda = self.device.type == "cuda"
            host = tuple(host_copy(t, cuda) for t in outputs)
            if not cuda:
                return Dispatch(host, None)
            done = torch.cuda.Event()
            done.record()
        return Dispatch(host, done, keep=(outputs, im1, im2, flow_init,
                                          *keep))
