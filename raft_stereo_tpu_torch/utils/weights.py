"""Weights for the port: from JAX variables, or from a reference checkpoint.

The port's modules carry the reference's ``state_dict`` names, so both
sources become a state dict that ``RAFTStereo.load_state_dict(...,
strict=True)`` accepts:

* :func:`state_dict_from_jax` renames a flax ``{"params", "batch_stats"}``
  tree (numpy leaves) onto the reference's keys — the port's own copy of
  the name map of ``raft_stereo_tpu/utils/checkpoint_convert.py``:

      trunk.*                       -> (flattened into the encoder)
      layer{L}_{j}                  -> layer{L}.{j}
      outputs{08,16}_{i}_{res,conv} -> outputs{08,16}.{i}.{0,1}
      outputs32_{i}_conv            -> outputs32.{i}
      down_conv                     -> downsample.0 (norm3: also downsample.1)
      refinement.update_block.*     -> update_block.*
      mask_conv{1,2}                -> mask.{0,2}
      conv2_res / conv2_out         -> conv2.0 / conv2.1
      context_zqr_convs_{i}         -> context_zqr_convs.{i}
      kernel (kH,kW,I,O) -> weight (O,I,kH,kW); scale -> weight;
      mean/var -> running_mean/running_var (+ num_batches_tracked)

* :func:`load_reference_checkpoint` reads a released RAFT-Stereo ``.pth``
  and strips the ``module.`` prefix its DataParallel wrapper added.

:func:`load_weights` is what the entry points read (``--restore_ckpt``): a
reference ``.pth``, a checkpoint directory of the port's trainer, or,
given neither, seeded random weights.

:func:`jax_leaf_names` runs the map the other way: it lists a model's
parameters in the order of the JAX package's parameter leaves, the order
of its per-leaf gradient norms.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from raft_stereo_tpu_torch.config import RAFTStereoConfig


def _flatten(tree: Mapping, prefix=()) -> Dict[tuple, Any]:
    out = {}
    for key, val in tree.items():
        if isinstance(val, Mapping):
            out.update(_flatten(val, prefix + (key,)))
        else:
            out[prefix + (key,)] = val
    return out


def _torch_module_path(flax_path) -> list:
    out = []
    for p in flax_path:
        m = re.fullmatch(r"outputs(08|16|32)_(\d+)_(res|conv)", p)
        if p in ("trunk", "refinement"):
            continue
        if re.fullmatch(r"layer[1-5]_[01]", p):
            out += p.split("_")
        elif m:
            scale, idx, kind = m.groups()
            out += ([f"outputs{scale}", idx] if scale == "32" else
                    [f"outputs{scale}", idx, "0" if kind == "res" else "1"])
        elif p == "down_conv":
            out += ["downsample", "0"]
        elif p in ("mask_conv1", "mask_conv2"):
            out += ["mask", "0" if p == "mask_conv1" else "2"]
        elif p in ("conv2_res", "conv2_out"):
            out += ["conv2", "0" if p == "conv2_res" else "1"]
        elif re.fullmatch(r"context_zqr_convs_\d+", p):
            out += ["context_zqr_convs", p.rsplit("_", 1)[1]]
        else:
            out.append(p)
    return out


def state_dict_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """flax ``{"params", "batch_stats"}`` tree -> the port's state dict."""
    state: Dict[str, torch.Tensor] = {}
    for path, val in _flatten(variables.get("params", {})).items():
        arr = np.array(val, dtype=np.float32)
        mod = ".".join(_torch_module_path(path[:-1]))
        if path[-1] == "kernel":
            state[f"{mod}.weight"] = torch.from_numpy(
                np.ascontiguousarray(arr.transpose(3, 2, 0, 1)))
        elif path[-1] == "scale":
            state[f"{mod}.weight"] = torch.from_numpy(arr)
        elif path[-1] == "bias":
            state[f"{mod}.bias"] = torch.from_numpy(arr)
        else:
            raise KeyError(f"unrecognized flax leaf {'/'.join(path)}")
    for path, val in _flatten(variables.get("batch_stats", {})).items():
        arr = np.array(val, dtype=np.float32)
        mod = ".".join(_torch_module_path(path[:-1]))
        leaf = {"mean": "running_mean", "var": "running_var"}[path[-1]]
        state[f"{mod}.{leaf}"] = torch.from_numpy(arr)
        state.setdefault(f"{mod}.num_batches_tracked",
                         torch.zeros((), dtype=torch.long))
    # the reference registers a residual block's shortcut norm twice, as
    # norm3 and as downsample.1
    for key in list(state):
        m = re.fullmatch(r"(.*\.|)norm3\.(\w+)", key)
        if m and f"{m.group(1)}downsample.0.weight" in state:
            state[f"{m.group(1)}downsample.1.{m.group(2)}"] = state[key]
    return state


def _unbuilt_prefixes(cfg: RAFTStereoConfig) -> tuple:
    """Modules the reference builds but never runs at ``cfg``'s GRU depth
    (and the port therefore does not build)."""
    dead = ()
    if cfg.n_gru_layers < 3:
        dead += ("cnet.layer5.", "cnet.outputs32.", "update_block.gru32.")
    if cfg.n_gru_layers < 2:
        dead += ("cnet.layer4.", "cnet.outputs16.", "update_block.gru16.")
    return dead


def load_reference_checkpoint(path: str,
                              cfg: Optional[RAFTStereoConfig] = None
                              ) -> Dict[str, torch.Tensor]:
    """A reference ``.pth`` as the port's state dict: the ``module.`` prefix
    stripped, and, given ``cfg``, the weights of modules the reference
    builds but never runs at that GRU depth dropped."""
    state = torch.load(path, map_location="cpu")
    state = {(k[len("module."):] if k.startswith("module.") else k): v
             for k, v in state.items()}
    if cfg is not None:
        dead = _unbuilt_prefixes(cfg)
        state = {k: v for k, v in state.items() if not k.startswith(dead)}
    return state


def load_weights(restore_ckpt: Optional[str],
                 cfg: RAFTStereoConfig) -> Dict[str, torch.Tensor]:
    """The weights an entry point serves, as a state dict of ``cfg``'s
    model: a reference ``.pth`` (:func:`load_reference_checkpoint`); a
    checkpoint directory written by ``training/checkpoint.py::
    save_train_state`` (the trainer's step, preempt and final checkpoints:
    its model half, loaded into ``cfg``'s model with ``strict=True`` and
    returned bitwise); or seeded random weights (seed 0) when
    ``restore_ckpt`` is None. The JAX package's ``load_variables`` takes
    the same two forms."""
    from raft_stereo_tpu_torch.models.raft_stereo import (RAFTStereo,
                                                          init_weights)
    from raft_stereo_tpu_torch.training.checkpoint import load_payload
    from raft_stereo_tpu_torch.training.resilience import \
        checkpoint_state_file
    model = RAFTStereo(cfg)
    if restore_ckpt is None:
        init_weights(model, torch.Generator().manual_seed(0))
        return model.state_dict()
    if restore_ckpt.endswith(".pth"):
        return load_reference_checkpoint(restore_ckpt, cfg)
    state_file = checkpoint_state_file(restore_ckpt)
    if not os.path.isfile(state_file):
        raise ValueError(
            f"{restore_ckpt}: neither a reference .pth nor a checkpoint "
            f"directory of the port's trainer (no {state_file})")
    model.load_state_dict(load_payload(restore_ckpt)["model"], strict=True)
    return model.state_dict()


def _flax_module_path(parts: List[str]) -> Tuple[str, ...]:
    """A port module path (split on dots) -> the JAX package's path."""
    out = ["refinement"] if parts[:1] == ["update_block"] else []
    i = 0
    while i < len(parts):
        p = parts[i]
        nxt = parts[i + 1] if i + 1 < len(parts) else None
        step = 2
        if re.fullmatch(r"layer[1-5]", p):
            out.append(f"{p}_{nxt}")
        elif p in ("outputs08", "outputs16"):
            kind = "res" if parts[i + 2] == "0" else "conv"
            out.append(f"{p}_{nxt}_{kind}")
            step = 3
        elif p == "outputs32":
            out.append(f"outputs32_{nxt}_conv")
        elif p == "downsample":  # downsample.1 is norm3 under a second name
            out.append("down_conv")
        elif p == "mask":
            out.append("mask_conv1" if nxt == "0" else "mask_conv2")
        elif p == "conv2" and nxt in ("0", "1"):
            out.append("conv2_res" if nxt == "0" else "conv2_out")
        elif p == "context_zqr_convs":
            out.append(f"context_zqr_convs_{nxt}")
        else:
            out.append(p)
            step = 1
        i += step
    # the encoders' stem and layer1-3 sit under "trunk"
    if (out[0] in ("cnet", "fnet") and len(out) > 1
            and re.fullmatch(r"conv1|norm1|layer[123]_\d", out[1])):
        out.insert(1, "trunk")
    return tuple(out)


def jax_leaf_names(model: torch.nn.Module
                   ) -> List[Tuple[str, Tuple[str, ...]]]:
    """``(port parameter name, JAX parameter path)`` for every parameter of
    ``model`` (each shared one once), in the order of the JAX package's
    ``jax.tree_util.tree_leaves(params)`` (sorted paths)."""
    modules = dict(model.named_modules())
    named = []
    for name, _ in model.named_parameters():
        mod_name, leaf = name.rsplit(".", 1)
        is_conv = isinstance(modules[mod_name], torch.nn.Conv2d)
        leaf = {"weight": "kernel" if is_conv else "scale",
                "bias": "bias"}[leaf]
        named.append((name, _flax_module_path(mod_name.split(".")) + (leaf,)))
    return sorted(named, key=lambda item: item[1])
