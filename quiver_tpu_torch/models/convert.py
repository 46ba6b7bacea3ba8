"""Parameters between the JAX package's flax models and this port's.

GraphSAGE: flax keeps ``{"params": {"conv{i}": {"lin_root": {"kernel",
"bias"}, "lin_nbr": {"kernel"}}}}``. GAT: ``{"params": {"conv{i}":
{"lin_src": {"kernel"}, "lin_dst": {"kernel"}, "att_src", "att_dst"}}}``
with the attention vectors ``[heads, width]``. RGCN: ``conv{i}`` holds
``rel__{src}__{rel}__{dst}`` (a kernel) and ``self__{dst}`` (kernel and
bias). The three share one pair of converters (``gat_*`` and ``rgcn_*``
name it too): each ``conv{i}`` becomes ``convs.{i}``. MAG240MGNN:
``conv{i}`` (either conv), ``skip{i}``, ``norm{i}``, ``mlp0``,
``mlp_norm``, ``mlp1``, LayerNorm's ``scale`` torch's ``weight``.
``nn.Dense.kernel`` is ``[in, out]`` and ``nn.Linear.weight`` ``[out,
in]``, so kernels are transposed. The flax side is plain nested dicts
of numpy-convertible arrays (the JAX package is never imported).
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch


def _kernel(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).T))


def _leaf(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _dense_sd(sd, pre: str, dense: dict):
    """A flax ``Dense`` (``kernel``, maybe ``bias``) as ``pre.weight`` and
    ``pre.bias``."""
    sd[f"{pre}.weight"] = _kernel(dense["kernel"])
    if "bias" in dense:
        sd[f"{pre}.bias"] = _leaf(dense["bias"])


def _conv_sd(sd, pre: str, conv: dict):
    """A flax conv's entries under ``pre``: each ``Dense`` by
    :func:`_dense_sd`, each array (GAT's attention vectors) as it is."""
    for name, v in conv.items():
        if isinstance(v, dict):
            _dense_sd(sd, f"{pre}.{name}", v)
        else:
            sd[f"{pre}.{name}"] = _leaf(v)


def _put_flax(node: dict, rest, t):
    """The state-dict leaf ``t`` at ``rest`` (``[module, "weight" or
    "bias"]``, or one name for an array) into the flax dict ``node``."""
    a = t.detach().cpu().numpy()
    if len(rest) == 1 and rest[0] not in ("weight", "bias"):
        node[rest[0]] = a
        return
    dense = node.setdefault(rest[0], {}) if len(rest) == 2 else node
    if rest[-1] == "weight":
        dense["kernel"] = np.ascontiguousarray(a.T)
    else:
        dense["bias"] = a


def flax_to_state_dict(variables) -> "OrderedDict[str, torch.Tensor]":
    """flax GraphSAGE, GAT or RGCN variables (with or without the
    ``"params"`` level) -> the port model's state dict (``conv{i}``
    becomes ``convs.{i}``)."""
    params = variables.get("params", variables)
    sd = OrderedDict()
    for i in range(len(params)):
        _conv_sd(sd, f"convs.{i}", params[f"conv{i}"])
    return sd


def state_dict_to_flax(sd) -> dict:
    """A ``GraphSAGE``, ``GAT`` or ``RGCN`` state dict -> flax variables
    of numpy arrays."""
    params: dict = {}
    for name, t in sd.items():
        _, i, *rest = name.split(".")
        _put_flax(params.setdefault(f"conv{i}", {}), rest, t)
    return {"params": params}


gat_flax_to_state_dict = flax_to_state_dict
gat_state_dict_to_flax = state_dict_to_flax
rgcn_flax_to_state_dict = flax_to_state_dict
rgcn_state_dict_to_flax = state_dict_to_flax


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


def random_rgcn_flax_params(in_dims, hidden_dim: int, out_dim: int,
                            edge_types, seed: int = 0) -> dict:
    """Random RGCN variables in flax's layout, made from ``seed`` with
    numpy as flax's ``init`` draws them: lecun-normal kernels, zero
    biases. ``edge_types[i]`` lists layer i's relations (as ``RGCN``
    takes them), ``in_dims`` the input width of each node type."""
    rng = np.random.default_rng(seed)
    params, dims = {}, dict(in_dims)
    for i, ets in enumerate(edge_types):
        out = out_dim if i == len(edge_types) - 1 else hidden_dim
        conv = {}
        for src, rel, dst in ets:
            conv[f"rel__{src}__{rel}__{dst}"] = {
                "kernel": _lecun_normal(rng, dims[src], out)}
        for dst in dict.fromkeys(et[2] for et in ets):
            conv[f"self__{dst}"] = {"kernel": _lecun_normal(rng, dims[dst],
                                                            out),
                                    "bias": np.zeros(out, np.float32)}
        params[f"conv{i}"] = conv
        dims = {t: hidden_dim for t in dims}
    return {"params": params}


_NORM = {"scale": "weight", "bias": "bias"}       # flax LayerNorm -> torch


def mag_flax_to_state_dict(variables) -> "OrderedDict[str, torch.Tensor]":
    """flax MAG240MGNN variables (with or without the ``"params"``
    level) -> a ``MAG240MGNN`` state dict: ``conv{i}``, ``skip{i}`` and
    ``norm{i}`` become ``convs.{i}``, ``skips.{i}`` and ``norms.{i}``;
    LayerNorm's ``scale`` is ``weight``."""
    params = variables.get("params", variables)
    sd = OrderedDict()
    for name, leaves in params.items():
        head = name.rstrip("0123456789")
        pre = f"{head}s.{name[len(head):]}" \
            if head in ("conv", "skip", "norm") else name
        if head == "conv":
            _conv_sd(sd, pre, leaves)
        elif "scale" in leaves:
            for k, v in leaves.items():
                sd[f"{pre}.{_NORM[k]}"] = _leaf(v)
        else:
            _dense_sd(sd, pre, leaves)
    return sd


def mag_state_dict_to_flax(sd) -> dict:
    """A ``MAG240MGNN`` state dict -> flax variables of numpy arrays."""
    params: dict = {}
    for name, t in sd.items():
        parts = name.split(".")
        if parts[0] in ("convs", "skips", "norms"):
            mod, rest = f"{parts[0][:-1]}{parts[1]}", parts[2:]
        else:
            mod, rest = parts[0], parts[1:]
        node = params.setdefault(mod, {})
        if mod.startswith("norm") or mod == "mlp_norm":
            inv = {v: k for k, v in _NORM.items()}
            node[inv[rest[0]]] = t.detach().cpu().numpy()
        else:
            _put_flax(node, rest, t)
    return {"params": params}


def random_mag_flax_params(model: str, in_dim: int, hidden_dim: int,
                           out_dim: int, num_layers: int, heads: int = 4,
                           seed: int = 0) -> dict:
    """Random MAG240MGNN variables in flax's layout, made from ``seed``
    with numpy as flax's ``init`` draws them: lecun-normal kernels, zero
    biases, the GAT attention vectors glorot-uniform over ``(heads,
    width)``, LayerNorm scales one and biases zero."""
    rng = np.random.default_rng(seed)
    params, width = {}, in_dim

    def dense(fan_in, fan_out, bias=True):
        d = {"kernel": _lecun_normal(rng, fan_in, fan_out)}
        if bias:
            d["bias"] = np.zeros(fan_out, np.float32)
        return d

    def norm():
        return {"scale": np.ones(hidden_dim, np.float32),
                "bias": np.zeros(hidden_dim, np.float32)}
    for i in range(num_layers):
        if model == "gat":
            f = hidden_dim // heads
            params[f"conv{i}"] = {
                "lin_src": dense(width, heads * f, False),
                "lin_dst": dense(width, heads * f, False),
                "att_src": _glorot_uniform(rng, heads, f),
                "att_dst": _glorot_uniform(rng, heads, f)}
            params[f"skip{i}"] = dense(width, hidden_dim)
        else:
            params[f"conv{i}"] = {"lin_root": dense(width, hidden_dim),
                                  "lin_nbr": dense(width, hidden_dim,
                                                   False)}
        params[f"norm{i}"] = norm()
        width = hidden_dim
    params["mlp0"] = dense(hidden_dim, hidden_dim)
    params["mlp_norm"] = norm()
    params["mlp1"] = dense(hidden_dim, out_dim)
    return {"params": params}
