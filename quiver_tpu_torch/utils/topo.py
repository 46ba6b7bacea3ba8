"""Device interconnect topology (counterpart of
``quiver_tpu/utils/topo.py``, the reference's ``Topo``/``init_p2p``,
utils.py:8-107 and quiver_feature.cu:363-413).

A clique is a set of cards that can all read each other's memory
(``torch.cuda.can_device_access_peer``, the reference's probe): cards
joined by NVLink, or on one PCIe switch. A card is in a clique with
itself. The CPU is one clique. :func:`init_p2p` enables peer access
between every pair of cards of a list (``cudaDeviceEnablePeerAccess``,
through the gather library), so that one kernel can read rows that lie
on any of them; cards that cannot reach each other raise, with no copy
fallback. The query API (``get_clique_id``, ``p2p_clique``, ``info``,
``Topo_Dict``) is the JAX package's.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch


def _ordinal(d) -> int:
    """A card's CUDA ordinal from an int, a ``torch.device`` or a
    string; -1 for the CPU."""
    if isinstance(d, int):
        return d
    dev = torch.device(d)
    if dev.type == "cpu":
        return -1
    return torch.cuda.current_device() if dev.index is None else dev.index


def can_device_access_peer(src: int, dst: int) -> bool:
    """Whether card ``src`` can read card ``dst``'s memory (a card can
    always read its own; the CPU, -1, only its own)."""
    if src == dst:
        return True
    if src < 0 or dst < 0:
        return False
    return bool(torch.cuda.can_device_access_peer(src, dst))


class Topo:
    """Cliques over a list of cards (CUDA ordinals, ``torch.device``s;
    every visible card by default, the CPU when there is none). Cards
    join a clique when they reach every card already in it, in list
    order; a repeated card joins its own clique."""

    def __init__(self, device_list: Optional[Sequence] = None):
        if device_list is None:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            device_list = list(range(n)) if n else [-1]
        self.devices = [_ordinal(d) for d in device_list]
        self.cliques: List[List[int]] = []
        self._clique_of = {}
        for d in self.devices:
            if d in self._clique_of:
                continue
            for cid, clique in enumerate(self.cliques):
                if all(can_device_access_peer(d, o)
                       and can_device_access_peer(o, d) for o in clique):
                    clique.append(d)
                    self._clique_of[d] = cid
                    break
            else:
                self._clique_of[d] = len(self.cliques)
                self.cliques.append([d])

    @property
    def Topo_Dict(self):
        return {cid: list(c) for cid, c in enumerate(self.cliques)}

    def get_clique_id(self, device) -> int:
        return self._clique_of[_ordinal(device)]

    def p2p_clique(self, clique_id: int) -> List[int]:
        return list(self.cliques[clique_id])

    def info(self) -> str:
        """The cliques as the JAX package prints them (its "ICI" is the
        card's peer access here), printed and returned."""
        lines = ["P2P topology:"]
        for cid, clique in enumerate(self.cliques):
            ids = ", ".join("cpu" if d < 0 else str(d) for d in clique)
            lines.append(f"  clique {cid} (peer-access-connected): "
                         f"devices [{ids}]")
        out = "\n".join(lines)
        print(out)
        return out


p2pCliqueTopo = Topo


def init_p2p(device_list: Optional[Sequence] = None) -> Topo:
    """Enable peer access both ways between every pair of different cards
    of ``device_list`` (every visible card by default) and return their
    ``Topo``. Raises when two of them cannot reach each other: a clique
    store's lookup reads every card's rows directly."""
    topo = Topo(device_list)
    cards = sorted({d for d in topo.devices if d >= 0})
    if len(cards) < 2:
        return topo
    from ..ops.kernels.gather import enable_peer_access
    for a in cards:
        for b in cards:
            if a == b:
                continue
            if not can_device_access_peer(a, b):
                raise RuntimeError(
                    f"cuda:{a} cannot access cuda:{b} (no peer access): "
                    "the cards of a clique must all reach each other")
            enable_peer_access(a, b)
    return topo
