"""Parameters between the JAX package's flax models and this port's.

GraphSAGE: flax keeps ``{"params": {"conv{i}": {"lin_root": {"kernel",
"bias"}, "lin_nbr": {"kernel"}}}}``. GAT: ``{"params": {"conv{i}":
{"lin_src": {"kernel"}, "lin_dst": {"kernel"}, "att_src", "att_dst"}}}``
with the attention vectors ``[heads, width]``. ``nn.Dense.kernel`` is
``[in, out]`` and ``nn.Linear.weight`` ``[out, in]``, so kernels are
transposed. The flax side is plain nested dicts of numpy-convertible
arrays (the JAX package is never imported).
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch


def flax_to_state_dict(variables) -> "OrderedDict[str, torch.Tensor]":
    """flax GraphSAGE variables (with or without the ``"params"`` level)
    -> a ``GraphSAGE`` state dict."""
    params = variables.get("params", variables)
    sd = OrderedDict()
    for i in range(len(params)):
        conv = params[f"conv{i}"]
        root, nbr = conv["lin_root"], conv["lin_nbr"]
        pre = f"convs.{i}"
        sd[f"{pre}.lin_root.weight"] = torch.from_numpy(
            np.ascontiguousarray(np.asarray(root["kernel"]).T))
        if "bias" in root:
            sd[f"{pre}.lin_root.bias"] = torch.from_numpy(
                np.array(root["bias"]))
        sd[f"{pre}.lin_nbr.weight"] = torch.from_numpy(
            np.ascontiguousarray(np.asarray(nbr["kernel"]).T))
    return sd


def state_dict_to_flax(sd) -> dict:
    """A ``GraphSAGE`` state dict -> flax variables of numpy arrays."""
    params: dict = {}
    for name, t in sd.items():
        _, i, lin, leaf = name.split(".")
        a = t.detach().cpu().numpy()
        conv = params.setdefault(f"conv{i}", {}).setdefault(lin, {})
        conv["kernel" if leaf == "weight" else "bias"] = \
            np.ascontiguousarray(a.T) if leaf == "weight" else a
    return {"params": params}


def random_flax_params(in_dim: int, hidden_dim: int, out_dim: int,
                       num_layers: int, seed: int = 0) -> dict:
    """Random GraphSAGE variables in flax's layout, made from ``seed``
    with numpy (lecun-normal kernels as flax draws them, zero biases)."""
    rng = np.random.default_rng(seed)
    dims = [in_dim] + [hidden_dim] * (num_layers - 1) + [out_dim]
    params = {}
    for i in range(num_layers):
        fan_in, fan_out = dims[i], dims[i + 1]
        kern = lambda: (rng.standard_normal((fan_in, fan_out))
                        / np.sqrt(fan_in)).astype(np.float32)
        params[f"conv{i}"] = {
            "lin_root": {"kernel": kern(),
                         "bias": np.zeros(fan_out, np.float32)},
            "lin_nbr": {"kernel": kern()},
        }
    return {"params": params}


def _lecun_normal(rng, fan_in: int, fan_out: int) -> np.ndarray:
    """flax's default ``Dense`` kernel: a normal truncated at two
    standard deviations, scaled to variance ``1 / fan_in``."""
    std = np.sqrt(1.0 / fan_in) / 0.87962566103423978
    z = rng.standard_normal((fan_in, fan_out))
    bad = np.abs(z) > 2.0
    while bad.any():
        z[bad] = rng.standard_normal(int(bad.sum()))
        bad = np.abs(z) > 2.0
    return (z * std).astype(np.float32)


def _glorot_uniform(rng, fan_in: int, fan_out: int) -> np.ndarray:
    limit = np.sqrt(6.0 / (fan_in + fan_out))
    return rng.uniform(-limit, limit, (fan_in, fan_out)).astype(np.float32)


def gat_flax_to_state_dict(variables) -> "OrderedDict[str, torch.Tensor]":
    """flax GAT variables (with or without the ``"params"`` level) -> a
    ``GAT`` state dict."""
    params = variables.get("params", variables)
    sd = OrderedDict()
    for i in range(len(params)):
        conv = params[f"conv{i}"]
        pre = f"convs.{i}"
        for lin in ("lin_src", "lin_dst"):
            sd[f"{pre}.{lin}.weight"] = torch.from_numpy(
                np.ascontiguousarray(np.asarray(conv[lin]["kernel"]).T))
        for att in ("att_src", "att_dst"):
            sd[f"{pre}.{att}"] = torch.from_numpy(np.array(conv[att]))
    return sd


def gat_state_dict_to_flax(sd) -> dict:
    """A ``GAT`` state dict -> flax variables of numpy arrays."""
    params: dict = {}
    for name, t in sd.items():
        _, i, leaf = name.split(".", 2)
        a = t.detach().cpu().numpy()
        conv = params.setdefault(f"conv{i}", {})
        if leaf.endswith(".weight"):
            conv[leaf[:-len(".weight")]] = {
                "kernel": np.ascontiguousarray(a.T)}
        else:
            conv[leaf] = a
    return {"params": params}


def random_gat_flax_params(in_dim: int, hidden_dim: int, out_dim: int,
                           num_layers: int, heads: int = 4,
                           seed: int = 0) -> dict:
    """Random GAT variables in flax's layout, made from ``seed`` with
    numpy as flax's ``init`` draws them: lecun-normal kernels, the
    attention vectors glorot-uniform over ``(heads, width)``."""
    rng = np.random.default_rng(seed)
    params, width = {}, in_dim
    for i in range(num_layers):
        last = i == num_layers - 1
        h, f = (1, out_dim) if last else (heads, hidden_dim)
        params[f"conv{i}"] = {
            "lin_src": {"kernel": _lecun_normal(rng, width, h * f)},
            "lin_dst": {"kernel": _lecun_normal(rng, width, h * f)},
            "att_src": _glorot_uniform(rng, h, f),
            "att_dst": _glorot_uniform(rng, h, f)}
        width = h * f
    return {"params": params}
