"""Parameters between the JAX package's flax GraphSAGE and this port's.

flax keeps ``{"params": {"conv{i}": {"lin_root": {"kernel", "bias"},
"lin_nbr": {"kernel"}}}}`` with ``nn.Dense.kernel`` as ``[in, out]``;
``nn.Linear.weight`` is ``[out, in]``, so kernels are transposed. The
flax side is plain nested dicts of numpy-convertible arrays (the JAX
package is never imported).
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
