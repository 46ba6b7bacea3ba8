"""GraphSAGE trained on weighted samples: ``GraphSageSampler(mode="GPU",
edge_weight=w)`` (the weighted pool draw of ``ops/weighted.py``), the
``Feature`` lookup of the frontier (``device_replicate``, the whole fp32
table on the card), then ``build_split_train_step``'s step: GraphSAGE
forward and backward and Adam. This is the loop of torch-quiver's
products example, with the repository's weighted sampler in place of
the uniform one.

Set-up drives the step from the seed through its first
``checked_steps`` steps, through the same loop as the window, and keeps
what each produced: the sampled blocks, the looked-up rows, the losses,
the first gradient as Adam got it, and the parameters after them. The
window dispatches steps back to back.

The check follows the program's sampled blocks, which are random draws
from the program's generator: each is judged by what it says (every
edge an edge of the graph among the target's first ``row_cap`` slots,
``min(deg, k)`` picks a target, the frontier the seeds and then every
new pick once), and the picks of all checked steps together by their
summed weight share against its expectation, in standard errors
(``weight_draw_z``). The reference then looks the frontier's rows up
again from the benchmark's own table, and trains its GraphSAGE on the
same blocks with the same dropout draws from the same initial weights;
it compares the losses, the first gradient and the parameters' change.
"""

from __future__ import annotations

import torch

from .. import data
from ..costs import flops as cflops
from ..reference import judge
from ..reference import models as rm
from . import base


class Driver(base.Driver):

    def setup(self):
        from quiver_tpu_torch import (CSRTopo, Feature, GraphSAGE,
                                      GraphSageSampler)
        from quiver_tpu_torch.parallel import (build_split_train_step,
                                               init_state)
        cfg, m, f = self.cfg, self.cfg["model"], self.cfg["features"]
        g = self.make_graph()
        self.make_features()
        self.weights = data.make_edge_weights(cfg, self.gen, self.dev,
                                              g.edges)
        self.batch = int(self.traffic["batch_size"])
        self.sizes = [int(k) for k in cfg["sizes"]]
        self.row_cap = int(cfg["row_cap"])
        feed = self.make_feed(self.batch)
        topo = CSRTopo(indptr=g.indptr, indices=g.indices, device=self.dev)
        smp = self.traffic["sampler"]
        self.sampler = GraphSageSampler(
            topo, self.sizes, device=self.dev, mode=smp["mode"],
            seed=feed.key(5), edge_weight=self.weights,
            sampling=smp["sampling"])
        self.store = Feature(
            device_cache_size=self.feat.numel() * self.feat.element_size(),
            cache_policy="device_replicate",
            device=self.dev).from_cpu_tensor(self.feat)
        self.model = GraphSAGE(f["dim"], m["hidden"], f["classes"],
                               m["layers"], dropout=m["dropout"]).to(self.dev)
        params = self.make_params(self.model)
        with torch.no_grad():
            for n, p in self.model.named_parameters():
                p.copy_(params[n])
        o = cfg["optimizer"]
        self.opt = torch.optim.Adam(self.model.parameters(), lr=o["lr"],
                                    betas=tuple(o["betas"]), eps=o["eps"])
        _, self.step_fn = build_split_train_step(self.model, self.opt,
                                                 self.sizes, self.batch)
        self.state = init_state(self.model, self.opt)
        self.losses, self.checked = [], []
        n = int(self.traffic["checked_steps"])
        for i in range(n):
            self.unit(i)
            if i == 0:
                self.grad1 = {k: t.clone() for k, t in
                              base.optimizer_grads(self.model,
                                                   self.opt).items()}
        self.params_end = base.params_of(self.model)
        self.checked_losses = [float(t) for t in self.losses]
        self.losses = []
        self.first_unit = n
        base.sync(self.dev)

    def unit(self, i):
        seeds = self.feed.ids(i)
        ds = self.feed.ints(i, 1)[0]
        if self.tracing:
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
        n_id, _, adjs = self.sampler.sample(seeds)
        if self.tracing:
            t1.record()
            self.traced.append((t0, t1, [a.edge_index for a in adjs[::-1]]))
        x = self.store.getitem_masked(n_id)
        if i < int(self.traffic["checked_steps"]):
            self.checked.append((seeds.clone(), n_id.clone(),
                                 [(a.edge_index.clone(), a.size)
                                  for a in adjs], x.clone(), ds))
        self.state, loss = self.step_fn(self.state, x, adjs,
                                        self.labels[seeds.long()], ds)
        self.losses.append(loss)

    def end_to_end(self, units, seconds):
        self.window_losses = torch.stack(self.losses) if self.losses \
            else torch.zeros(0, device=self.dev)
        return {"train_seeds_per_s": units * self.batch / seconds}

    def release(self):
        self.nonfinite = int((~torch.isfinite(self.window_losses)).sum())
        del self.step_fn, self.state, self.model, self.opt, self.losses
        del self.window_losses, self.sampler, self.store, self.traced
        torch.cuda.empty_cache()

    # -- the reference ----------------------------------------------------
    def _ref_steps(self):
        steps = []
        for seeds, n_id, blocks, _, ds in self.checked:
            n_id = n_id.long()
            x = self.feat[n_id.clamp(min=0)] * (n_id >= 0)[:, None].float()
            steps.append({"x": x, "blocks": blocks,
                          "labels": self.labels[seeds.long()],
                          "dropout_seed": ds})
        return steps

    def _ref_train(self, steps, on_tf32: bool):
        m, o = self.cfg["model"], self.cfg["optimizer"]
        with base.tf32(on_tf32):
            losses, g1, p = rm.train_steps(rm.sage_forward, self.params0,
                                           steps, o["lr"], self.batch,
                                           dropout=m["dropout"])
        return {"losses": losses, "grad1": g1, "params0": self.params0,
                "params_end": p}

    def readings(self):
        g = judge.SampledCSR(self.graph.indptr, self.graph.indices,
                             self.weights, self.row_cap)
        faults, rows = 0, 0
        share = {"share_sum": 0.0, "share_mean": 0.0, "share_var": 0.0}
        steps = self._ref_steps()
        for (seeds, n_id, blocks, x, _), st in zip(self.checked, steps):
            hops = [(ei, k) for (ei, _), k in zip(blocks[::-1], self.sizes)]
            r = judge.judge_hops(g, n_id, seeds, hops, row_cap=self.row_cap)
            faults += r["faults"]
            for k in share:
                share[k] += r[k]
            rows += int((x != st["x"]).any(dim=1).sum())
        del g
        prog = {"losses": self.checked_losses, "grad1": self.grad1,
                "params0": self.params0, "params_end": self.params_end}
        out = judge.train_readings(prog, self._ref_train(steps, False))
        out["pick_faults"] = faults
        out["weight_draw_z"] = judge.weight_draw_z(**share)
        out["lookup_mismatch"] = rows
        out["nonfinite_losses"] = self.nonfinite
        return out

    def control_readings(self):
        steps = self._ref_steps()
        return judge.train_readings(self._ref_train(steps, True),
                                    self._ref_train(steps, False))

    # -- the trace's facts ------------------------------------------------
    def trace_facts(self, units):
        m, f = self.cfg["model"], self.cfg["features"]
        dims = [f["dim"]] + [m["hidden"]] * (m["layers"] - 1) \
            + [f["classes"]]
        flops, span_ms = 0, 0.0
        for t0, t1, hops in self.traced:
            span_ms += t0.elapsed_time(t1)
            flops += cflops.sage_step(base.adj_block_sizes(hops, self.batch),
                                      dims)
        n = max(len(self.traced), 1)
        return {"model_flops": flops, "sampler_ms": span_ms / n,
                "tf32": bool(torch.backends.cuda.matmul.allow_tf32)}
