"""K4 with an entity axis and the GRU scan under ``vmap(grad(...))``, on the CPU.

Sizes of ``tests/test_multi_entity.py`` (hidden 12, window 10), a few
entities of a few rows each; the tensors lie on the CPU, so the kernels'
grouped plain versions run.

- The grouped plain K4 (``gru_scan_bwd_plain`` and ``gru_weight_grads_plain``
  with grouped weights) equals its per-entity calls bit for bit, and
  ``jax.vmap`` of the VJP of ``gru_scan_fused`` (the Pallas kernel in
  interpret mode) within atol 1e-5.
- ``vmap(grad(...))`` through ``gru_scan`` calls K3's and K4's vmap rules
  once a step for E = 1, 3 and 5, and its gradients equal per-entity
  autograd; weights that vmap does not batch get each entity's gradient.
- The guards see the fleet's composition: ``_vmap.is_batched`` and
  ``entities`` through the grad wrapper; ``gatv2_attention`` with gradients
  or dropout inside a fleet step trains through the grouped K1-res and K2ab
  (their plain versions here), each entity's gradients its solo call's,
  a graph whose backward takes the CHUNKED tile too (item 7d).
- ``weight_grad_chunks`` with groups: the least count a group whose waves
  on the card cost within 5% of the best; one group the ungrouped count.
- ``torch.func.grad`` outside vmap goes through the ops and equals autograd.
- ``cuda``-marked: the grouped K4 against G ungrouped launches, bit for bit
  (skipped without a card).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad, vmap

from mtad_gat_tpu.kernels.gru_pallas import gru_scan_fused
from mtad_gat_tpu_torch.kernels import _vmap
from mtad_gat_tpu_torch.kernels import gat as kg
from mtad_gat_tpu_torch.kernels import gru as kgru

torch.set_num_threads(1)

H, T = 12, 10


def _inputs(G, rows, seed=0, grouped=True):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: torch.from_numpy(  # noqa: E731
        (scale * rng.standard_normal(s)).astype(np.float32))
    gi = f(G * rows, T, 3 * H)
    lead = (G,) if grouped else ()
    w, b = f(*lead, H, 3 * H, scale=0.3), f(*lead, 3 * H, scale=0.1)
    dh = f(G * rows, T, H, scale=0.5)
    return gi, w, b, dh


@pytest.mark.parametrize("G,rows", [(1, 4), (3, 2), (5, 3)])
def test_grouped_plain_k4_equals_per_entity_calls(G, rows):
    gi, w, b, dh = _inputs(G, rows)
    with torch.no_grad():
        hseq = kgru.gru_scan_fwd_plain(gi, w, b, H)[0]
        dgi, dw, db = kgru.gru_scan_bwd_plain(gi, w, b, hseq, dh, H)
    assert dw.shape == (G, H, 3 * H) and db.shape == (G, 3 * H)
    for g in range(G):
        rs = slice(g * rows, (g + 1) * rows)
        want = kgru.gru_scan_bwd_plain(gi[rs], w[g], b[g], hseq[rs], dh[rs], H)
        assert torch.equal(dgi[rs], want[0])
        assert torch.equal(dw[g], want[1]) and torch.equal(db[g], want[2])


@pytest.mark.parametrize("G,rows", [(3, 2), (5, 3)])
def test_grouped_plain_weights_product_equals_per_entity_calls(G, rows):
    gi, w, b, dh = _inputs(G, rows, seed=1)
    hseq = kgru.gru_scan_fwd_plain(gi, w, b, H)[0]
    dgi = torch.randn(G * rows, T, 3 * H, generator=torch.Generator().manual_seed(0))
    dghn = torch.randn(G * rows, T, H, generator=torch.Generator().manual_seed(1))
    dw, db = kgru.gru_weight_grads_plain(hseq, dgi, dghn, H, groups=G)
    for g in range(G):
        rs = slice(g * rows, (g + 1) * rows)
        want = kgru.gru_weight_grads_plain(hseq[rs], dgi[rs], dghn[rs], H)
        assert torch.equal(dw[g], want[0]) and torch.equal(db[g], want[1])


@pytest.mark.parametrize("G,rows", [(3, 2), (5, 3)])
def test_grouped_plain_k4_equals_jax_vmap_of_the_pallas_vjp(G, rows):
    gi, w, b, dh = _inputs(G, rows, seed=2)
    with torch.no_grad():
        hseq = kgru.gru_scan_fwd_plain(gi, w, b, H)[0]
        dgi, dw, db = kgru.gru_scan_bwd_plain(gi, w, b, hseq, dh, H)

    def vjp(gi_e, w_e, b_e, dh_e):
        _, pull = jax.vjp(lambda x, ww, bb: gru_scan_fused(x, ww, bb, H, interpret=True)[0],
                          gi_e, w_e, b_e)
        return pull(dh_e)

    shape = lambda t: jnp.asarray(t.numpy().reshape(G, rows, *t.shape[1:]))  # noqa: E731
    jg, jw, jb = jax.vmap(vjp)(shape(gi), jnp.asarray(w.numpy()), jnp.asarray(b.numpy()),
                               shape(dh))
    np.testing.assert_allclose(dgi.numpy(), np.asarray(jg).reshape(dgi.shape), atol=1e-5)
    np.testing.assert_allclose(dw.numpy(), np.asarray(jw), atol=1e-5)
    np.testing.assert_allclose(db.numpy(), np.asarray(jb), atol=1e-5)


def _loss(w, b, gi):
    """A loss of both outputs of the scan, w in nn.GRU's (3H, H) layout."""
    hseq, last = kgru.gru_scan(gi, w.t(), b, H)
    return (hseq ** 2).sum() + (last * 0.5).sum()


@pytest.mark.parametrize("E", [1, 3, 5])
def test_vmap_grad_calls_each_rule_once_a_step(E):
    rows = 2
    gi, w, b, _ = _inputs(E, rows, seed=3)
    w = w.transpose(1, 2).contiguous()        # (E, 3H, H), as the parameter
    rules = (kgru._gru_scan_fwd_vmap.calls, kgru._gru_scan_bwd_vmap.calls)
    for step in range(2):
        gw, gb, ggi = vmap(grad(_loss, argnums=(0, 1, 2)))(w, b, gi.view(E, rows, T, 3 * H))
        assert (kgru._gru_scan_fwd_vmap.calls - rules[0],
                kgru._gru_scan_bwd_vmap.calls - rules[1]) == (step + 1, step + 1)
    for e in range(E):
        we, be, ge = (t.clone().requires_grad_() for t in (w[e], b[e], gi[e * rows:(e + 1) * rows]))
        _loss(we, be, ge).backward()
        assert torch.equal(gw[e], we.grad) and torch.equal(gb[e], be.grad)
        assert torch.equal(ggi[e], ge.grad)


def test_vmap_grad_with_shared_weights_gives_each_entity_its_gradient():
    E, rows = 3, 2
    gi, w, b, _ = _inputs(E, rows, seed=4, grouped=False)
    w = w.t().contiguous()
    gw, gb = vmap(grad(_loss, argnums=(0, 1)), in_dims=(None, None, 0))(
        w, b, gi.view(E, rows, T, 3 * H))
    assert gw.shape == (E, 3 * H, H)
    for e in range(E):
        we, be = w.clone().requires_grad_(), b.clone().requires_grad_()
        _loss(we, be, gi[e * rows:(e + 1) * rows]).backward()
        torch.testing.assert_close(gw[e], we.grad, rtol=0, atol=1e-6)
        torch.testing.assert_close(gb[e], be.grad, rtol=0, atol=1e-6)


def test_vmap_then_backward_gives_each_entity_its_gradient():
    """Autograd outside the vmap (stacked weights that require gradients):
    the Function records under vmap and its backward runs K4's op."""
    E, rows = 3, 2
    gi, w, b, _ = _inputs(E, rows, seed=6)
    w = w.transpose(1, 2).contiguous().requires_grad_()
    b = b.clone().requires_grad_()
    rules = kgru._gru_scan_bwd_vmap.calls
    vmap(_loss)(w, b, gi.view(E, rows, T, 3 * H)).sum().backward()
    assert kgru._gru_scan_bwd_vmap.calls == rules + 1
    for e in range(E):
        we, be = w[e].detach().clone().requires_grad_(), b[e].detach().clone().requires_grad_()
        _loss(we, be, gi[e * rows:(e + 1) * rows]).backward()
        assert torch.equal(w.grad[e], we.grad) and torch.equal(b.grad[e], be.grad)


def test_the_guards_see_a_batched_tensor_under_grad():
    seen = {}

    def f(x):
        seen["batched"], seen["entities"] = _vmap.is_batched(x), _vmap.entities(x)
        return (x ** 2).sum()

    vmap(grad(f))(torch.ones(4, 3))
    assert seen == {"batched": True, "entities": 4}
    vmap(vmap(grad(f)))(torch.ones(2, 3, 5))
    assert seen == {"batched": True, "entities": 6}
    grad(f)(torch.ones(3))
    assert seen == {"batched": False, "entities": 1}


@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_attention_with_gradients_in_a_fleet_step_names_item_7b(rate):
    """Item 7b is done: the attention with gradients inside a fleet step
    (vmap over grad) runs K1-res's and the backward's ops, whose rules call
    the grouped plain versions here (no launch on the CPU), and each
    entity's gradients are its solo call's. Item 7c is done too: a graph
    the whole-graph kernels cannot hold (N 130: the tiled backward) runs
    and matches its solo calls the same way; one whose backward would take
    the CHUNKED tile (N 65 at E 600, D 300), the variant left, runs and
    matches its solo calls too since item 7d."""
    G, B, N, E_, D = 2, 2, 4, 6, 3
    g = torch.Generator().manual_seed(0)
    p, q, v = (torch.randn(G, B, N, n, generator=g) for n in (E_, E_, D))
    a = torch.randn(G, E_, generator=g)
    launches = kg.gatv2_attention_fwd.launches, kg.gatv2_attention_res.launches

    def loss(a_e, p_e, q_e, v_e):
        return kg.gatv2_attention(p_e, q_e, a_e, None, v_e, 0.2, 0, rate).sum()

    got = vmap(grad(loss, argnums=(0, 1)))(a, p, q, v)
    assert (kg.gatv2_attention_fwd.launches, kg.gatv2_attention_res.launches) == launches
    for e in range(G):
        want = grad(loss, argnums=(0, 1))(a[e], p[e], q[e], v[e])
        for x, w in zip(got, want):
            torch.testing.assert_close(x[e], w, rtol=0, atol=1e-6)
    wide = torch.randn(G, 1, 130, E_, generator=g), torch.randn(G, 1, 130, E_, generator=g)
    v_wide = torch.randn(G, 1, 130, D, generator=g)
    got = vmap(grad(loss, argnums=(0, 1)))(a, *wide, v_wide)
    for e in range(G):
        want = grad(loss, argnums=(0, 1))(a[e], wide[0][e], wide[1][e], v_wide[e])
        for x, w in zip(got, want):
            torch.testing.assert_close(x[e], w, rtol=0, atol=1e-6)
    chunked = torch.randn(G, 1, 65, 600, generator=g), torch.randn(G, 1, 65, 600, generator=g)
    a_chunked = torch.randn(G, 600, generator=g) * 0.1
    v_chunked = torch.randn(G, 1, 65, 300, generator=g)
    got = vmap(grad(loss, argnums=(0, 1)))(a_chunked, *chunked, v_chunked)
    for e in range(G):
        want = grad(loss, argnums=(0, 1))(a_chunked[e], chunked[0][e], chunked[1][e],
                                          v_chunked[e])
        for x, w in zip(got, want):
            torch.testing.assert_close(x[e], w, rtol=0, atol=1e-6)


@pytest.mark.parametrize("rows,groups,want", [
    (6400, 1, 44), (100, 1, 7), (6400, 28, 3), (25600, 28, 3), (16, 28, 1), (100, 3, 7),
    (6400, 5, 17), (6400, 44, 1),
])
def test_weight_grad_chunks_fill_the_card_across_groups(rows, groups, want):
    """Hidden 150 on 132 multiprocessors: 44 chunks a wave. One group keeps
    the ungrouped count; G groups take the least S whose waves times a
    chunk's rows lies within 5% of the best."""
    H_, sms, fill = 150, 132, 44
    assert kgru.weight_grad_chunks(10 ** 9, H_, sms) == fill
    S = kgru.weight_grad_chunks(rows, H_, sms, groups=groups)
    assert S == want
    most = min(-(-rows // kgru.W_RM), fill)
    cost = lambda s: -(-groups * s // fill) / s  # noqa: E731
    best = min(cost(s) for s in range(1, most + 1))
    if groups > 1:
        assert cost(S) <= 1.05 * best and all(cost(s) > 1.05 * best for s in range(1, S))


def test_functorch_grad_outside_vmap_matches_autograd():
    """Under ``torch.func.grad`` alone the tensors are grad wrappers, which
    have no data pointer (``_vmap.is_wrapped``): the scan's forward and
    backward then go through the custom ops, whose bodies get them
    unwrapped, and the gradients equal autograd's."""
    gi, w, b, _ = _inputs(1, 3, seed=5, grouped=False)
    w = w.t().contiguous()
    gw, gb = grad(_loss, argnums=(0, 1))(w, b, gi)
    we, be = w.clone().requires_grad_(), b.clone().requires_grad_()
    _loss(we, be, gi).backward()
    assert torch.equal(gw, we.grad) and torch.equal(gb, be.grad)
    seen = []
    grad(lambda x: seen.append(_vmap.is_wrapped(x)) or (x ** 2).sum())(torch.ones(2))
    assert seen == [True] and not _vmap.is_wrapped(torch.ones(2), None)


# ---------------------------------------------------------------------------
# On the card: grouped K4 against G ungrouped launches
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("hid_dim", [150, 384])
@pytest.mark.parametrize("rows", [1, 13, 64])
def test_grouped_k4_equals_g_launches_on_the_card(hid_dim, rows, card):
    G, T_, Hc = 7, 20, hid_dim
    g = torch.Generator().manual_seed(rows)
    gi = torch.randn(G * rows, T_, 3 * Hc, generator=g).to(card)
    w = (Hc ** -0.5 * torch.randn(G, Hc, 3 * Hc, generator=g)).to(card)
    b = (Hc ** -0.5 * torch.randn(G, 3 * Hc, generator=g)).to(card)
    dh = (0.1 * torch.randn(G * rows, T_, Hc, generator=g)).to(card)
    hseq = kgru.gru_scan_fwd(gi, w, b, Hc)[0]
    dgi, dw, db = kgru.gru_scan_bwd(gi, w, b, hseq, dh, Hc)
    assert kgru.gru_scan_bwd.last_launch["groups"] == G
    S = kgru.gru_weight_grads.last_launch["chunks"]
    for i in range(G):
        rs = slice(i * rows, (i + 1) * rows)
        d, _, _ = kgru.gru_scan_bwd(gi[rs], w[i], b[i], hseq[rs], dh[rs], Hc, need_weights=False)
        assert torch.equal(dgi[rs], d)
    x = [torch.randn(G * rows, T_, n, generator=g).to(card) for n in (Hc, 3 * Hc, Hc)]
    gw, gb = kgru.gru_weight_grads(*x, Hc, G)
    for i in range(G):
        rs = slice(i * rows, (i + 1) * rows)
        pw, pb = kgru.gru_weight_grads(*(t[rs].contiguous() for t in x), Hc, chunks=S)
        assert torch.equal(gw[i], pw) and torch.equal(gb[i], pb)
