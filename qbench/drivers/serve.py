"""The served point query over a tiered store: ``serving.py:
ServeEngine.run`` with the fused walk, over a ``Feature`` store whose
hot quarter (by degree) is int8 on the card and whose cold rows are
int8, packed, in pinned host memory (``host_placement="offload"``,
``dedup_cold=True``).

A closed loop with one client: each batch of distinct node ids goes
when the last batch's logits are on the host, and its latency is timed
from the call to its logits on the host. One batch in ``keep_every``
(at an offset drawn from the seed), and the first, is kept.

The check: for each kept batch the reference walks again from the same
ids and per-hop seeds (the kernels' counter hash), codes the
benchmark's fp32 table to int8 by rows and decodes it, and runs
GraphSAGE in eval mode; it compares the logits. The number compared is
the largest logit gap over the kept batches, over the reference's
root-mean-square logit.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..costs import flops as cflops
from ..costs import kernel_bytes
from ..reference import models as rm
from ..reference import quant as rq
from ..reference import walk as rw
from . import base


class Driver(base.Driver):

    def setup(self):
        from quiver_tpu_torch import CSRTopo, Feature, GraphSAGE, ServeEngine
        cfg, m, f = self.cfg, self.cfg["model"], self.cfg["features"]
        g = self.make_graph()
        self.make_features()
        self.batch = int(self.traffic["batch_size"])
        self.sizes = [int(k) for k in cfg["sizes"]]
        self.row_cap = int(cfg["row_cap"])
        feed = self.make_feed(self.batch)
        model = GraphSAGE(f["dim"], m["hidden"], f["classes"], m["layers"],
                          dropout=m["dropout"])
        params = self.make_params(model)
        st = self.traffic["store"]
        self.hot_rows = int(g.nodes * float(st["hot_fraction"]))
        topo = CSRTopo(indptr=g.indptr, indices=g.indices, device=self.dev)
        row = 1 * f["dim"] + 8        # int8 codes and fp32 scale and zero
        store = Feature(device_cache_size=self.hot_rows * row,
                        csr_topo=topo, dedup_cold=bool(st["dedup_cold"]),
                        dtype_policy=st["dtype_policy"],
                        host_placement=st["host_placement"],
                        device=self.dev).from_cpu_tensor(self.feat)
        self.eng = ServeEngine(model, params, topo, store, [self.sizes],
                               self.batch, fused_hot_hop=True,
                               fused_row_cap=self.row_cap,
                               seed=feed.key(5), device=self.dev).warmup()
        self.every = int(self.traffic["keep_every"])
        self.kept, self.lat = [], []
        warm = int(self.traffic["warm_units"])
        for i in range(warm):
            self.unit(i)
        self.lat = []
        self.first_unit = warm
        base.sync(self.dev)

    def _inputs(self, i):
        return self.feed.ids(i), self.feed.ints(i, len(self.sizes))

    def unit(self, i):
        ids, hs = self._inputs(i)
        t0 = time.perf_counter()
        out = self.eng.run(ids, hop_seeds=hs).cpu()
        self.lat.append(time.perf_counter() - t0)
        if i == 0 or self.feed.keep(i, self.every):
            self.kept.append((i, out))
        if self.tracing:
            self.traced.append(i)

    def end_to_end(self, units, seconds):
        ms = np.asarray(self.lat) * 1e3
        return {"serve_batch_p95_ms": float(np.percentile(ms, 95))}

    def release(self):
        del self.eng
        torch.cuda.empty_cache()

    # -- the reference ----------------------------------------------------
    def _ref_logits(self, i, table, on_tf32: bool):
        ids, hs = self._inputs(i)
        hops = rw.walk(self.graph.indptr, self.graph.indices, ids,
                       self.sizes, hs, self.row_cap)
        n_id = hops[-1].layer.n_id
        x = table[n_id.clamp(min=0)] * (n_id >= 0)[:, None].float()
        caps = base.frontier_caps(self.batch, self.sizes)
        with base.tf32(on_tf32), torch.no_grad():
            return rm.sage_forward(self.params0, x, rw.blocks(hops, caps))

    def _gap(self, side) -> float:
        table = rq.int8_rows(self.feat)
        worst = 0.0
        for i, out in self.kept:
            ref = self._ref_logits(i, table, False).double()
            got = side(i, table).double()
            rms = float(ref.pow(2).mean().sqrt())
            worst = max(worst, float((got - ref).abs().max()) / rms)
        return worst

    def readings(self):
        kept = dict(self.kept)
        return {"logit_gap": self._gap(
            lambda i, table: kept[i].to(self.dev))}

    def control_readings(self):
        return {"logit_gap": self._gap(
            lambda i, table: self._ref_logits(i, table, True))}

    # -- the trace's facts ------------------------------------------------
    def trace_facts(self, units):
        f, m = self.cfg["features"], self.cfg["model"]
        dims = [f["dim"]] + [m["hidden"]] * (m["layers"] - 1) \
            + [f["classes"]]
        # the hot tier holds the nodes of highest degree
        rank = torch.empty(self.graph.nodes, dtype=torch.int64,
                           device=self.dev)
        order = torch.argsort(self.graph.deg, descending=True, stable=True)
        rank[order] = torch.arange(self.graph.nodes, device=self.dev)
        host, dev, flops = 0, 0, 0
        for i in self.traced:
            ids, hs = self._inputs(i)
            hops = rw.walk(self.graph.indptr, self.graph.indices, ids,
                           self.sizes, hs, self.row_cap)
            n_id = hops[-1].layer.n_id
            cold = torch.where((n_id >= 0) & (rank[n_id.clamp(min=0)]
                                              >= self.hot_rows), n_id, -1)
            hb, db, _ = kernel_bytes.gather_rows_bytes(cold, f["dim"] + 8,
                                                       f["dim"])
            host, dev = host + hb, dev + db
            flops += cflops.sage_step(base.adj_block_sizes(
                [torch.stack([h.layer.col, h.layer.row]) for h in hops],
                self.batch), dims, train=False)
        return {"host_gather_host_bytes": host,
                "host_gather_device_bytes": dev, "model_flops": flops,
                "tf32": bool(torch.backends.cuda.matmul.allow_tf32)}
