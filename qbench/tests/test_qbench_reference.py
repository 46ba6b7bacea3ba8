"""The plain reference against the program at a tiny size on the CPU,
and the reference's independence from the program."""

import subprocess
import sys

import torch

from qbench.reference import judge, models as rm, quant as rq, walk as rw


def _graph(seed=3, n=3000):
    g = torch.Generator().manual_seed(seed)
    deg = torch.exp(torch.randn(n, generator=g) + 2.5).long().clamp(0, 3000)
    deg[:5] = 2500          # rows above the walk's row_cap
    deg[5:9] = 0            # isolated rows
    indptr = torch.zeros(n + 1, dtype=torch.int64)
    indptr[1:] = deg.cumsum(0)
    indices = torch.randint(0, n, (int(indptr[-1]),), generator=g,
                            dtype=torch.int32)
    return indptr.to(torch.int32), indices, g


def test_walk_equals_the_programs_fused_walk():
    from quiver_tpu_torch.ops.kernels.fused import fused_multihop
    indptr, indices, g = _graph()
    feat = torch.randn(3000, 16, generator=g)
    seeds = torch.cat([torch.arange(9), torch.randperm(3000, generator=g)[
        :55] + 9]).clamp(max=2999).unique().to(torch.int32)
    sizes, hs = [4, 3, 2], [123, -5, 2 ** 31 - 7]
    _, layers, x = fused_multihop(indptr, indices, seeds, feat, sizes, hs,
                                  row_cap=2048)
    hops = rw.walk(indptr, indices, seeds, sizes, hs, 2048)
    for a, h in zip(layers, hops):
        assert torch.equal(a.n_id.long(), h.layer.n_id)
        assert torch.equal(a.row.long(), h.layer.row)
        assert torch.equal(a.col.long(), h.layer.col)
    n_id = hops[-1].layer.n_id
    ref = feat[n_id.clamp(min=0)] * (n_id >= 0)[:, None].float()
    assert torch.equal(x, ref)


def test_sage_training_equals_the_programs_step():
    from quiver_tpu_torch import GraphSAGE
    from quiver_tpu_torch.parallel import build_train_step, init_state
    indptr, indices, g = _graph(5)
    n = 3000
    feat = torch.randn(n, 16, generator=g)
    labels = torch.randint(0, 5, (n,), generator=g, dtype=torch.int32)
    model = GraphSAGE(16, 32, 5, 3, dropout=0.5)
    p0 = {k: v.detach().clone() for k, v in model.named_parameters()}
    opt = torch.optim.Adam(model.parameters(), lr=3e-3)
    sizes = [4, 3, 2]
    step = build_train_step(model, opt, sizes, 64, fused_hot_hop=True)
    state = init_state(model, opt)
    losses, steps = [], []
    caps = [64, 320, 1280, 3840]
    for t in range(3):
        sd = torch.randperm(n, generator=g)[:64].to(torch.int32)
        hs = [int(v) for v in torch.randint(-2 ** 31, 2 ** 31 - 1, (3,),
                                            generator=g)]
        ds = int(torch.randint(0, 2 ** 31, (1,), generator=g))
        state, loss = step(state, feat, None, indptr, indices, sd,
                           labels[sd.long()], hs, ds)
        losses.append(float(loss))
        if t == 0:
            g1 = {k: opt.state[p]["exp_avg"] / 0.1
                  for k, p in model.named_parameters()}
        hops = rw.walk(indptr, indices, sd, sizes, hs, 2048)
        n_id = hops[-1].layer.n_id
        steps.append({"x": feat[n_id.clamp(min=0)]
                      * (n_id >= 0)[:, None].float(),
                      "blocks": rw.blocks(hops, caps),
                      "labels": labels[sd.long()], "dropout_seed": ds})
    rl, rg, rp = rm.train_steps(rm.sage_forward, p0, steps, 3e-3, 64,
                                dropout=0.5)
    prog = {"losses": losses, "grad1": g1, "params0": p0,
            "params_end": {k: p.detach() for k, p in
                           model.named_parameters()}}
    r = judge.train_readings(prog, {"losses": rl, "grad1": rg,
                                    "params0": p0, "params_end": rp})
    assert r["loss_gap"] < 1e-5 and r["grad_gap"] < 1e-5 \
        and r["delta_gap"] < 1e-4


def test_int8_rows_equal_the_programs_code():
    from quiver_tpu_torch.ops import quant
    x = torch.randn(50, 7)
    x[3] = 2.0                       # a constant row
    q = quant.quantize(x, "int8")
    assert torch.equal(quant.dequantize(q), rq.int8_rows(x))


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys; import qbench.reference.walk, "
            "qbench.reference.models, qbench.reference.quant, "
            "qbench.reference.judge, qbench.costs.kernel_bytes, "
            "qbench.costs.flops; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'quiver_tpu_torch', 'quiver_tpu', 'jax'}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.stdout.strip() == "[]", out.stderr


def _weighted_sample(seed: int, weights_of=lambda w: w):
    """A weighted sample of the program's on the CPU (``weights_of``
    gives the weights the draw is handed), with its graph and the
    weights the draw was meant to use."""
    from quiver_tpu_torch import CSRTopo, GraphSageSampler
    indptr, indices, g = _graph(seed)
    w = torch.randn(indices.shape[0], generator=g).exp()
    topo = CSRTopo(indptr=indptr, indices=indices, device="cpu")
    smp = GraphSageSampler(topo, [6, 4], device="cpu", mode="GPU", seed=3,
                           edge_weight=weights_of(w))
    seeds = torch.randperm(3000, generator=g)[:400].to(torch.int32)
    n_id, _, adjs = smp.sample(seeds)
    hops = [(a.edge_index, k) for a, k in zip(adjs[::-1], [6, 4])]
    return indptr, indices, w, n_id, seeds, hops


def test_judge_finds_faults_in_a_sampled_batch():
    indptr, indices, _, n_id, seeds, hops = _weighted_sample(9)
    csr = judge.SampledCSR(indptr, indices)
    assert judge.judge_hops(csr, n_id, seeds, hops, 2048)["faults"] == 0
    # a pick that is no neighbour
    bad = [(h.clone(), k) for h, k in hops]
    live = (bad[0][0][0] >= 0).nonzero()[0, 0]
    bad[0][0][0, live] = 0 if int(bad[0][0][0, live]) != 0 else 1
    assert judge.judge_hops(csr, n_id, seeds, bad, 2048)["faults"] > 0
    # a target left with fewer picks than min(deg, k)
    short = [(h.clone(), k) for h, k in hops]
    short[1][0][:, (short[1][0][0] >= 0).nonzero()[0, 0]] = -1
    assert judge.judge_hops(csr, n_id, seeds, short, 2048)["faults"] > 0
    # a pick beyond the row's first row_cap slots (rows 0-4 hold 2,500)
    assert judge.judge_hops(csr, n_id, seeds, hops, 1)["faults"] > 0


def _weighted_batch(uniform: bool):
    indptr, indices, w, n_id, seeds, hops = _weighted_sample(
        11, torch.ones_like if uniform else (lambda w: w))
    return judge.judge_hops(judge.SampledCSR(indptr, indices, w, 2048),
                            n_id, seeds, hops, row_cap=2048)


def test_weighted_draw_reads_within_its_error_and_uniform_far_out():
    good = _weighted_batch(False)
    assert good["faults"] == 0 and good["share_var"] > 0
    z = judge.weight_draw_z(good["share_sum"], good["share_mean"],
                            good["share_var"])
    assert z < 4.0
    bad = _weighted_batch(True)
    assert bad["faults"] == 0
    assert judge.weight_draw_z(bad["share_sum"], bad["share_mean"],
                               bad["share_var"]) > 20.0


def test_draw_moments_by_hand():
    # row 0: slots 1, 2, 1 with weights 1, 3, 2 (node 1 twice: W = 3);
    # row 1: one edge
    indptr = torch.tensor([0, 3, 4], dtype=torch.int32)
    indices = torch.tensor([1, 0, 1, 0], dtype=torch.int32)
    w = torch.tensor([1.0, 3.0, 2.0, 5.0])
    g = judge.SampledCSR(indptr, indices, w)
    share, mean, var, counts = g.draw_moments(torch.tensor([0, 0, 1]),
                                              torch.tensor([1, 0, 0]))
    assert torch.allclose(share, torch.tensor([0.5, 0.5, 1.0],
                                              dtype=torch.float64))
    assert float(mean[0]) == 0.5 and float(var[0]) == 0.0
    assert counts.tolist() == [True, True, False]
    # with a cap of 2 slots row 0's pool is slots 0, 1: W(0->1) = 1
    capped = judge.SampledCSR(indptr, indices, w, row_cap=2)
    share, mean, _, _ = capped.draw_moments(torch.tensor([0]),
                                            torch.tensor([1]))
    assert float(share[0]) == 0.25 and float(mean[0]) == (1 + 9) / 16
