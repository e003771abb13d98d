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
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional

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
