"""Weights into the port: JAX param trees and reference torch state_dicts.

The port's module tree carries the reference torch ``state_dict`` keys.
The flax -> torch name map below (``_torch_key`` and its helpers) is a
copy of the one in p2p_bridge_tpu/utils/torch_compat.py; tests hold the
two equal on the PVDS_PUNet and TINY parameter trees.

* ``load_jax_params(model, params)`` maps every flax leaf to its torch key
  with ``_torch_key`` and transposes its layout (kernel [in, out] ->
  weight [out, in]; conv kernel [3, 3, 3, in, out] -> [out, in, 3, 3, 3]).
* ``tensors_to_jax_tree(tensors, template)`` is the other direction for
  any per-parameter tensors keyed like the model's state_dict (weights,
  gradients, Adam moments, EMA): each leaf of the flax ``template`` tree
  gets the tensor of its torch key in flax layout, so two trainings
  compare leaf by leaf. ``flax_template(model)`` is that template built
  from the port's own parameter names (``flax_path``, the inverse of the
  name map), so the port writes flax trees where no JAX is installed.
* ``flat_flax_arrays`` / ``flat_to_state_dict`` carry any such tensors to
  and from flat ``{"a/b/c": array}`` dicts, the layout of an exported
  checkpoint: weights, EMA and both Adam moments take the same names and
  the same transposes.
* ``load_torch_state_dict(model, sd)`` loads a reference checkpoint; its
  1x1 convolutions ([out, in, 1] or [out, in, 1, 1]) load into the port's
  Linear weights [out, in].

Every loader is strict: each port parameter is set exactly once and each
source entry is used.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

Path = Tuple[str, ...]
# leaf name -> torch parameter name; full attention's qk_norm gains keep theirs
_LEAF_TO_TORCH = {"kernel": "weight", "scale": "weight", "bias": "bias",
                  "q_gamma": "q_gamma", "k_gamma": "k_gamma"}


def _torch_key(flax_path, conv_counts) -> str:
    """Map one flax param path (tuple of names, without the trailing
    kernel/bias leaf) to the torch parameter prefix."""
    top = flax_path[0]
    rest = flax_path[1:]

    if top == "embedf":
        k = int(rest[0].split("_")[1])
        return f"embedf.{0 if k == 0 else 2}"
    if top == "embed_feats_0":
        return "embed_feats.0"
    if top == "embed_feats_gn":
        return "embed_feats.1"
    if top == "embed_feats_1":
        return "embed_feats.3"
    if top == "global_pnet":
        m = int(rest[0].split("_")[1]) + 1  # MyGroupNormMLP_{0,1} -> mlp{1,2}
        sub = rest[1]
        k = int(sub.split("_")[1])
        base = f"global_pnet.mlp{m}.shared_mlp_{k}.mlp"
        if sub.startswith("Dense"):
            return f"{base}.0"
        return f"{base}.1.group_norm"
    if top == "global_att":
        # its Dense layers, or the module itself for the qk_norm gains
        return f"global_att.{rest[0]}" if rest else "global_att"
    if top == "classifier_mlp":
        if rest[0].startswith("Dense"):
            return "classifier.0.layers.0"
        return "classifier.0.layers.1"
    if top == "classifier_out":
        return "classifier.2"

    # sa{i}_conv{j} / sa{i}_module / fp{j}_module / fp{j}_conv{k}
    if top.startswith("sa") and "_conv" in top:
        i, j = int(top[2:].split("_conv")[0]), int(top.split("_conv")[1])
        nconvs = conv_counts["sa"][i]
        prefix = f"sa_layers.{i}.{j}" if nconvs + 1 > 1 else f"sa_layers.{i}"
        return _pvconv_key(prefix, rest)
    if top.startswith("sa") and top.endswith("_module"):
        i = int(top[2:].split("_")[0])
        nconvs = conv_counts["sa"][i]
        prefix = f"sa_layers.{i}.{nconvs}" if nconvs > 0 else f"sa_layers.{i}"
        return _shared_mlp_key(f"{prefix}.mlps.0.layers", rest[1:])
    if top.startswith("fp") and top.endswith("_module"):
        j = int(top[2:].split("_")[0])
        nconvs = conv_counts["fp"][j]
        prefix = f"fp_layers.{j}.0" if nconvs > 0 else f"fp_layers.{j}"
        return _shared_mlp_key(f"{prefix}.mlp.layers", rest[1:])
    if top.startswith("fp") and "_conv" in top:
        j, k = int(top[2:].split("_conv")[0]), int(top.split("_conv")[1])
        prefix = f"fp_layers.{j}.{k + 1}"
        return _pvconv_key(prefix, rest)
    raise KeyError(f"unmapped flax module: {flax_path}")


def _pvconv_key(prefix, rest) -> str:
    node = rest[0]
    if node == "vconv1":
        return f"{prefix}.voxel_layers.0"
    if node == "vconv2":
        return f"{prefix}.voxel_layers.4"
    if node == "vnorm1":
        return _norm_key(f"{prefix}.voxel_layers.1", rest[1:])
    if node == "vnorm2":
        return _norm_key(f"{prefix}.voxel_layers.5", rest[1:])
    if node == "SE_0":
        k = int(rest[1].split("_")[1])
        return f"{prefix}.voxel_layers.6.fc.{0 if k == 0 else 2}"
    if node == "point_features":
        sub = rest[1]
        if sub.startswith("Dense"):
            return f"{prefix}.point_features.layers.0"
        return _norm_key(f"{prefix}.point_features.layers.1", rest[2:])
    if node == "attn":
        return f"{prefix}.attn.{rest[1]}"
    raise KeyError(f"unmapped PVConv node: {prefix} {rest}")


def _norm_key(prefix, rest) -> str:
    """AdaGN (GroupNorm_0 + Dense_0 children) or plain GroupNorm."""
    if not rest:  # plain GroupNorm leaf module
        return prefix
    inner = rest[0]
    if inner.startswith("GroupNorm"):
        return f"{prefix}.norm"
    if inner.startswith("Dense"):
        return f"{prefix}.emd"
    raise KeyError(f"unmapped norm node: {prefix} {rest}")


def _shared_mlp_key(base, rest) -> str:
    node = rest[0]
    k = int(node.split("_")[1])
    if node.startswith("Dense"):
        return f"{base}.{3 * k}"
    # AdaGN_k -> layers.{3k+1}
    return _norm_key(f"{base}.{3 * k + 1}", rest[1:])


def flatten_params(params: Mapping) -> Dict[Path, np.ndarray]:
    """Nested dicts of arrays -> {path: numpy array}. A top-level
    ``{"params": tree}`` wrapper (flax variables) is unwrapped."""
    if set(params) == {"params"}:
        params = params["params"]
    flat: Dict[Path, np.ndarray] = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, Mapping):
                walk(v, prefix + (str(k),))
            else:
                flat[prefix + (str(k),)] = np.asarray(v)

    walk(params, ())
    return flat


def unflatten_params(flat: Mapping[str, np.ndarray], sep: str = "/") -> dict:
    """{"a/b/c": array} (the .npz layout) -> nested dicts."""
    tree: dict = {}
    for key, value in flat.items():
        parts = key.split(sep)
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.asarray(value)
    return tree


def _conv_counts(paths) -> dict:
    """PVConvs per SA/FP stage, as convert_torch_state_dict counts them."""
    counts = {"sa": {}, "fp": {}}
    for path in paths:
        name = path[0]
        if not name.startswith(("sa", "fp")):
            continue
        kind = name[:2]
        if "_conv" in name:
            stage = int(name[2:].split("_conv")[0])
            j = int(name.split("_conv")[1])
            counts[kind][stage] = max(counts[kind].get(stage, 0), j + 1)
        elif name.endswith("_module"):
            counts[kind].setdefault(int(name[2:].split("_")[0]), 0)
    return counts


def _to_torch_layout(leaf: np.ndarray, leaf_name: str) -> np.ndarray:
    """A flax leaf in the port's torch layout."""
    if leaf_name != "kernel":
        return leaf
    if leaf.ndim == 2:  # Dense [in, out] -> Linear [out, in]
        return leaf.T
    if leaf.ndim == 5:  # [k, k, k, in, out] -> Conv3d [out, in, k, k, k]
        return leaf.transpose(4, 3, 0, 1, 2)
    raise ValueError(f"unexpected kernel rank {leaf.ndim}")


def _to_flax_layout(value: np.ndarray, leaf_name: str) -> np.ndarray:
    """The inverse of :func:`_to_torch_layout`."""
    if leaf_name != "kernel":
        return value
    if value.ndim == 2:
        return value.T
    if value.ndim == 5:  # [out, in, k, k, k] -> [k, k, k, in, out]
        return value.transpose(2, 3, 4, 1, 0)
    raise ValueError(f"unexpected kernel rank {value.ndim}")


def tensors_to_jax_tree(tensors: Mapping[str, torch.Tensor], template: Mapping) -> dict:
    """Nested dicts shaped like the flax param tree ``template`` (with or
    without its ``{"params": ...}`` wrapper, which the result keeps), each
    leaf the f32 numpy value of ``tensors[torch key]`` in flax layout."""
    wrapped = set(template) == {"params"}
    flat = flatten_params(template)
    counts = _conv_counts(flat)
    tree: dict = {}
    for path in flat:
        key = f"{_torch_key(path[:-1], counts)}.{_LEAF_TO_TORCH[path[-1]]}"
        value = tensors[key].detach().float().cpu().numpy()
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = _to_flax_layout(value, path[-1])
    return {"params": tree} if wrapped else tree


def _flax_norm(rest: str) -> Path:
    """The flax names under a norm node whose torch suffix is ``rest``:
    "" for a plain GroupNorm, ".norm" / ".emd" for AdaGN's children."""
    return {"": (), ".norm": ("GroupNorm_0",), ".emd": ("Dense_0",)}[rest]


def _flax_shared_mlp(rest: str) -> Path:
    """``N[.norm|.emd]`` of a SharedMLP's ``layers`` -> its flax names."""
    m = re.fullmatch(r"(\d+)(\.norm|\.emd)?", rest)
    n, norm = int(m.group(1)), m.group(2) or ""
    if n % 3 == 0:
        return (f"Dense_{n // 3}",)
    if n % 3 != 1:
        raise KeyError(rest)
    if norm:  # AdaGN_k with its own GroupNorm and Dense
        return (f"AdaGN_{n // 3}",) + _flax_norm(norm)
    return (f"GroupNorm_{n // 3}",)


def _flax_pvconv(rest: str) -> Path:
    """The rest of a PVConv's torch key -> its flax names."""
    m = re.fullmatch(r"voxel_layers\.([0145])(\.norm|\.emd)?", rest)
    if m:
        node = {"0": "vconv1", "1": "vnorm1", "4": "vconv2", "5": "vnorm2"}[m.group(1)]
        return (node,) + _flax_norm(m.group(2) or "")
    m = re.fullmatch(r"voxel_layers\.6\.fc\.([02])", rest)
    if m:
        return ("SE_0", f"Dense_{int(m.group(1)) // 2}")
    m = re.fullmatch(r"point_features\.layers\.([01])(\.norm|\.emd)?", rest)
    if m:
        if m.group(1) == "0":
            return ("point_features", "Dense_0")
        if m.group(2):
            return ("point_features", "AdaGN_0") + _flax_norm(m.group(2))
        return ("point_features", "GroupNorm_0")
    m = re.fullmatch(r"attn\.(\w+)", rest)
    if m:
        return ("attn", m.group(1))
    raise KeyError(rest)


def _flax_module(prefix: str) -> Path:
    """The flax module path of the port module ``prefix`` (a torch key
    without its parameter name): the inverse of ``_torch_key``."""
    fixed = {"embedf.0": ("embedf", "Dense_0"), "embedf.2": ("embedf", "Dense_1"),
             "embed_feats.0": ("embed_feats_0",), "embed_feats.1": ("embed_feats_gn",),
             "embed_feats.3": ("embed_feats_1",), "classifier.0.layers.0": ("classifier_mlp", "Dense_0"),
             "classifier.0.layers.1": ("classifier_mlp", "GroupNorm_0"),
             "classifier.2": ("classifier_out",), "global_att": ("global_att",)}
    if prefix in fixed:
        return fixed[prefix]
    m = re.fullmatch(r"global_pnet\.mlp(\d+)\.shared_mlp_(\d+)\.mlp\.(0|1\.group_norm)", prefix)
    if m:
        node = "Dense" if m.group(3) == "0" else "GroupNorm"
        return ("global_pnet", f"MyGroupNormMLP_{int(m.group(1)) - 1}", f"{node}_{m.group(2)}")
    m = re.fullmatch(r"global_att\.(\w+)", prefix)
    if m:
        return ("global_att", m.group(1))
    m = re.fullmatch(r"sa_layers\.(\d+)(?:\.(\d+))?\.(.+)", prefix)
    if m:
        i, rest = m.group(1), m.group(3)
        if rest.startswith("mlps.0.layers."):
            return (f"sa{i}_module", "mlp") + _flax_shared_mlp(rest[len("mlps.0.layers."):])
        return (f"sa{i}_conv{m.group(2)}",) + _flax_pvconv(rest)
    m = re.fullmatch(r"fp_layers\.(\d+)(?:\.(\d+))?\.(.+)", prefix)
    if m:
        j, k, rest = m.group(1), m.group(2), m.group(3)
        if rest.startswith("mlp.layers.") and k in (None, "0"):
            return (f"fp{j}_module", "mlp") + _flax_shared_mlp(rest[len("mlp.layers."):])
        return (f"fp{j}_conv{int(k) - 1}",) + _flax_pvconv(rest)
    raise KeyError(prefix)


def flax_path(key: str, ndim: int) -> Path:
    """The flax param path (inside the "params" collection) of the port
    parameter ``key`` of rank ``ndim``."""
    prefix, name = key.rsplit(".", 1)
    if name == "weight":
        leaf = "kernel" if ndim >= 2 else "scale"
    elif name in ("bias", "q_gamma", "k_gamma"):
        leaf = name
    else:
        raise KeyError(key)
    try:
        return _flax_module(prefix) + (leaf,)
    except (KeyError, AttributeError) as e:
        raise KeyError(f"no flax path for the port parameter {key}") from e


def flax_template(model: nn.Module) -> dict:
    """The flax param tree of ``model`` (no "params" wrapper), each leaf an
    empty placeholder: a template for ``tensors_to_jax_tree``. Each path
    is checked to map back to its own key."""
    tree: dict = {}
    paths = {key: flax_path(key, t.dim()) for key, t in model.state_dict().items()}
    counts = _conv_counts(paths.values())
    for key, path in paths.items():
        back = f"{_torch_key(path[:-1], counts)}.{_LEAF_TO_TORCH[path[-1]]}"
        if back != key:
            raise KeyError(f"{key} -> {'/'.join(path)} -> {back}")
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = np.zeros(0, np.float32)
    return tree


def flat_flax_arrays(tensors: Mapping[str, torch.Tensor], template: Mapping) -> Dict[str, np.ndarray]:
    """``tensors`` keyed like the model's state_dict -> {"a/b/c": f32 numpy
    in flax layout} over the leaves of ``template`` (``flax_template``)."""
    tree = tensors_to_jax_tree(tensors, template)
    return {"/".join(path): leaf for path, leaf in flatten_params(tree).items()}


def flat_to_state_dict(flat: Mapping[str, np.ndarray], model: nn.Module) -> Dict[str, torch.Tensor]:
    """{"a/b/c": array} in flax layout -> {torch key: f32 tensor} covering
    every entry of ``model``'s state_dict exactly once (strict, as
    ``jax_params_to_state_dict``)."""
    return jax_params_to_state_dict(unflatten_params(flat), model)


def jax_params_to_state_dict(params: Mapping, model: nn.Module) -> Dict[str, torch.Tensor]:
    """The port state_dict holding ``params`` (a JAX/flax param tree)."""
    target = model.state_dict()
    flat = flatten_params(params)
    counts = _conv_counts(flat)
    out: Dict[str, torch.Tensor] = {}
    for path, leaf in flat.items():
        leaf_name = path[-1]
        key = f"{_torch_key(path[:-1], counts)}.{_LEAF_TO_TORCH[leaf_name]}"
        if key not in target:
            raise KeyError(f"{'/'.join(path)} maps to {key}, which the model lacks")
        if key in out:
            raise KeyError(f"{key} is mapped twice (second: {'/'.join(path)})")
        value = _to_torch_layout(leaf, leaf_name)
        if tuple(value.shape) != tuple(target[key].shape):
            raise ValueError(f"shape of {key}: model {tuple(target[key].shape)}, "
                             f"params {tuple(value.shape)} ({'/'.join(path)})")
        out[key] = torch.tensor(value, dtype=torch.float32)
    missing = sorted(set(target) - set(out))
    if missing:
        raise KeyError(f"params leave {len(missing)} model entries unset: {missing[:8]}")
    return out


def load_jax_params(model: nn.Module, params: Mapping) -> nn.Module:
    """Load a JAX param tree (nested dicts of numpy arrays) into ``model``."""
    model.load_state_dict(jax_params_to_state_dict(params, model), strict=True)
    return model


def load_torch_state_dict(model: nn.Module, state_dict: Mapping) -> nn.Module:
    """Load a reference-named torch state_dict into ``model`` (strict).
    Weights of 1x1 convolutions load into the matching Linear weights."""
    target = model.state_dict()
    extra = sorted(set(state_dict) - set(target))
    missing = sorted(set(target) - set(state_dict))
    if extra or missing:
        raise KeyError(f"state_dict mismatch: missing {missing[:8]}, unexpected {extra[:8]}")
    out = {}
    for key, want in target.items():
        value = torch.as_tensor(state_dict[key])
        if value.shape != want.shape:
            squeezed = value.reshape(value.shape[:2]) if (
                value.dim() > 2 and all(s == 1 for s in value.shape[2:])) else value
            if squeezed.shape != want.shape:
                raise ValueError(f"shape of {key}: model {tuple(want.shape)}, "
                                 f"checkpoint {tuple(value.shape)}")
            value = squeezed
        out[key] = value.to(want.dtype)
    model.load_state_dict(out, strict=True)
    return model
