"""Grouped K1-res and the attention backward against G ungrouped launches on
an NVIDIA GPU.

``cuda``-marked, skipped without a card; no JAX here, so the file runs on a
machine with only the port's dependencies:

    python -m pytest -m cuda --noconftest tests/test_torch_gat_fleet_cuda.py

At both SMD layers (feature N 38, E 200, D 100; temporal N 100, E 76, D
38), G 5 groups of 1, 13 and 64 rows, float32 and bfloat16, dropout 0.3 with
one seed a group and bias: the grouped K1-res (out, u, m, l) and K2ab with
dbias (dp, dq, dv by row, da (G, E) and dbias (G, N, N)) equal each group's
own launch bit for bit. At the lookback-300 layers (temporal N 300, E 76,
D 38: the tiled K1-res, K2a and K2b with dbias; feature N 38, E 600, D 300:
the whole-graph K1-res on two row blocks, the streamed backward with dbias)
and at the feature layer of 65 features (N 65, E 600, D 300: the tiled
K1-res, the CHUNKED K2a and K2b with dbias) the same holds, K2a and K2b
launched per group at the grouped launch's plan.
``tests/test_torch_gat_fleet.py`` and ``tests/test_torch_gat_fleet_wide.py``
hold their plain versions and the vmapped training call on the CPU.
"""

import pytest
import torch

from mtad_gat_tpu_torch.kernels import gat as kg

ALPHA = 0.2
SEED = 2**31 + 5


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("N,E,D", [(38, 200, 100), (100, 76, 38)])
@pytest.mark.parametrize("rows", [1, 13, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_k1res_and_k2ab_equal_g_launches_on_the_card(N, E, D, rows, dtype, card):
    G = 5
    gen = torch.Generator().manual_seed(rows)
    r = lambda *s, scale=1.0: (scale * torch.randn(*s, generator=gen)).to(card)  # noqa: E731
    p, q, v = (r(G * rows, N, n, scale=0.5).to(dtype) for n in (E, E, D))
    a, bias = r(G, E, scale=0.1).to(dtype), r(G, N, N, scale=0.1)
    seeds = SEED + torch.arange(G, dtype=torch.int64)
    seeds = seeds.to(card)
    outs = kg.gatv2_attention_res(p, q, a, bias, v, ALPHA, seeds, 0.3)
    assert kg.gatv2_attention_res.last_launch["groups"] == G
    _, u, m, l = outs
    sig = torch.sigmoid(u)
    du = r(G * rows, N, D) * sig * (1 - sig)
    dvec = (du * u).sum(-1)
    got = kg.gatv2_bwd_graph(p, q, a, bias, v, m, l, du, dvec, ALPHA, seeds, 0.3, dbias=True)
    for g in range(G):
        sl = lambda t: t[g * rows:(g + 1) * rows]  # noqa: E731
        want = kg.gatv2_attention_res(sl(p), sl(q), a[g], bias[g], sl(v), ALPHA,
                                      seeds[g:g + 1], 0.3)
        assert all(torch.equal(sl(x), y) for x, y in zip(outs, want))
        wb = kg.gatv2_bwd_graph(sl(p), sl(q), a[g], bias[g], sl(v), sl(m), sl(l), sl(du),
                                sl(dvec), ALPHA, seeds[g:g + 1], 0.3, dbias=True)
        assert torch.equal(sl(got[0]), wb[0]) and torch.equal(sl(got[1]), wb[1])
        assert torch.equal(got[2][g], wb[2]) and torch.equal(sl(got[3]), wb[3])
        assert torch.equal(got[4][g], wb[4])


@pytest.mark.cuda
@pytest.mark.parametrize("N,E,D", [(300, 76, 38), (38, 600, 300), (65, 600, 300)])
@pytest.mark.parametrize("rows", [1, 13, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_wide_kernels_equal_g_launches_on_the_card(N, E, D, rows, dtype, card):
    G = 5
    gen = torch.Generator().manual_seed(rows)
    r = lambda *s, scale=1.0: (scale * torch.randn(*s, generator=gen)).to(card)  # noqa: E731
    p, q, v = (r(G * rows, N, n, scale=0.5).to(dtype) for n in (E, E, D))
    a, bias = r(G, E, scale=0.1).to(dtype), r(G, N, N, scale=0.1)
    seeds = (SEED + torch.arange(G, dtype=torch.int64)).to(card)
    outs = kg.gatv2_attention_res(p, q, a, bias, v, ALPHA, seeds, 0.3)
    launch = kg.gatv2_attention_res.last_launch
    assert launch["groups"] == G and launch["variant"] == kg.gat_fwd_plan(N, E, D)
    _, u, m, l = outs
    sig = torch.sigmoid(u)
    du = r(G * rows, N, D) * sig * (1 - sig)
    dvec = (du * u).sum(-1)
    args = (p, q, a, bias, v, m, l, du, dvec, ALPHA, seeds, 0.3)
    tiled = kg.gat_bwd_route(N, E, D) == "tiled"
    if tiled:
        dp, da = kg.gatv2_bwd_dp_da(*args)
        pa = kg.gatv2_bwd_dp_da.last_plan
        dq, dv, db = kg.gatv2_bwd_dq_dv(*args, dbias=True)
        pb = kg.gatv2_bwd_dq_dv.last_plan
        got = (dp, dq, da, dv, db)
    else:
        got = kg.gatv2_bwd_streamed(*args, dbias=True)
    assert got[2].shape == (G, E) and got[4].shape == (G, N, N)
    for g in range(G):
        sl = lambda t: t[g * rows:(g + 1) * rows]  # noqa: E731
        want = kg.gatv2_attention_res(sl(p), sl(q), a[g], bias[g], sl(v), ALPHA,
                                      seeds[g:g + 1], 0.3)
        assert all(torch.equal(sl(x), y) for x, y in zip(outs, want))
        one = (sl(p), sl(q), a[g], bias[g], sl(v), sl(m), sl(l), sl(du), sl(dvec), ALPHA,
               seeds[g:g + 1], 0.3)
        if tiled:
            wa = kg.gatv2_bwd_dp_da(*one, plan=pa)
            wb = kg.gatv2_bwd_dq_dv(*one, dbias=True, plan=pb)
            wg = (wa[0], wb[0], wa[1], wb[1], wb[2])
        else:
            wg = kg.gatv2_bwd_streamed(*one, dbias=True)
        assert torch.equal(sl(got[0]), wg[0]) and torch.equal(sl(got[1]), wg[1])
        assert torch.equal(got[2][g], wg[2]) and torch.equal(sl(got[3]), wg[3])
        assert torch.equal(got[4][g], wg[4])
