"""The dense-to-kernel route for complete GATv2 graphs too large for the
dense path (``nn/gat.py``), on the CPU.

- The byte model (``dense_gatv2_bytes``) grows with each of b, N and e, is
  larger in float32 than in bfloat16 and no smaller with autograd than
  without;
  ``dense_route_nodes`` is the least N it routes.
- The threshold: pinned by ``DENSE_AUTO_SCORE_BYTES``; 7/8 of a CUDA
  device's total memory, read once a device (the device's properties
  mocked here); 14 GiB on the CPU. The flagship layers (batch 256) stay on
  the dense path.
- With the threshold pinned to 1 byte, the routed layer matches the dense
  one within 1e-5 in float32, output and every gradient, in eval and in
  training at dropout 0 (both compute the same float32 function; the kernels'
  plain versions sum in another order, a few 1e-7 apart); at dropout 0.3 it
  trains with the kernels' hash mask from a seed drawn from the caller's
  generator. On the CPU the route reaches the plain versions of K1, or of
  K1-res and the backward, as spies show, and no kernel launches.
"""

from unittest import mock

import numpy as np
import pytest
import torch

import mtad_gat_tpu_torch.kernels.gat as kg
import mtad_gat_tpu_torch.nn.gat as ngat
from mtad_gat_tpu_torch.nn import FeatureAttention, TemporalAttention

torch.set_num_threads(1)


def test_byte_model_is_monotone():
    for s in (2, 4):
        for grad in (False, True):
            base = dict(b=2, n=50, e=16, itemsize=s, grad=grad)
            ref = ngat.dense_gatv2_bytes(**base)
            for key, bigger in (("b", 3), ("n", 51), ("e", 17)):
                assert ngat.dense_gatv2_bytes(**{**base, key: bigger}) > ref, key
            assert ngat.dense_gatv2_bytes(**{**base, "grad": True}) >= ref
        assert (ngat.dense_gatv2_bytes(2, 50, 16, 2, False)
                < ngat.dense_gatv2_bytes(2, 50, 16, 4, False))
    for grad in (False, True):
        for b, e, s in ((1, 76, 4), (4, 200, 2), (256, 76, 4)):
            limit = 7 * 2**33
            n = ngat.dense_route_nodes(b, e, s, grad, limit)
            assert ngat.dense_gatv2_bytes(b, n, e, s, grad) > limit
            assert n == 1 or ngat.dense_gatv2_bytes(b, n - 1, e, s, grad) <= limit


def test_threshold_pinned_card_and_cpu(monkeypatch):
    monkeypatch.setattr(ngat, "DENSE_AUTO_SCORE_BYTES", None)
    monkeypatch.setattr(ngat, "_device_limit", {})
    assert ngat.dense_route_threshold(torch.device("cpu")) == 14 * 2**30
    calls = []

    class Props:
        total_memory = 80 * 10**9

    def props(index):
        calls.append(index)
        return Props()

    monkeypatch.setattr(torch.cuda, "get_device_properties", props)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    for dev in ("cuda:1", "cuda", "cuda:1"):
        assert ngat.dense_route_threshold(torch.device(dev)) == 70 * 10**9
    assert calls == [1]                                  # read once a device
    monkeypatch.setattr(ngat, "DENSE_AUTO_SCORE_BYTES", 123)
    assert ngat.dense_route_threshold(torch.device("cuda:0")) == 123


@pytest.mark.parametrize("layer,kw", [
    (FeatureAttention, dict(n_features=38, window_size=100)),
    (TemporalAttention, dict(n_features=38, window_size=100)),
])
def test_flagship_layers_stay_dense(layer, kw, monkeypatch):
    monkeypatch.setattr(ngat, "DENSE_AUTO_SCORE_BYTES", None)
    gat = layer(dropout=0.3, alpha=0.2, **kw)
    v = torch.zeros(256, gat.n_nodes, gat.node_dim)
    assert not gat.dense_route(v)
    with torch.no_grad():
        assert not gat.dense_route(v)


def _layers(cls, seed, **kw):
    g = lambda: torch.Generator().manual_seed(seed)  # noqa: E731
    return cls(dropout=0.3, alpha=0.2, generator=g(), **kw), cls(dropout=0.3, alpha=0.2,
                                                                 generator=g(), **kw)


@pytest.mark.parametrize("cls", [FeatureAttention, TemporalAttention])
@pytest.mark.parametrize("mode", ["eval", "train"])
def test_routed_layer_matches_dense(cls, mode, monkeypatch):
    dense, routed = _layers(cls, 3, n_features=5, window_size=9, embed_dim=6)
    for m in (dense, routed):
        m.train(mode == "train")
        m.dropout = 0.0
        with torch.no_grad():
            m.bias.normal_(0, 0.3, generator=torch.Generator().manual_seed(4))
    x = torch.tensor(np.random.default_rng(0).standard_normal((3, 9, 5)), dtype=torch.float32)
    cot = torch.tensor(np.random.default_rng(1).standard_normal((3, 9, 5)), dtype=torch.float32)

    plain = {name: getattr(kg, name) for name in
             ("gatv2_attention_fwd_plain", "gatv2_attention_res_plain",
              "gatv2_attention_bwd_plain")}
    called = []

    def spy(name):
        def f(*a, **k):
            called.append(name)
            return plain[name](*a, **k)
        return f

    launches = {n: getattr(kg, n).launches for n in ("gatv2_attention_fwd",
                                                     "gatv2_attention_res",
                                                     "gatv2_bwd_graph")}
    outs = {}
    for name, layer, pin in (("dense", dense, None), ("routed", routed, 1)):
        monkeypatch.setattr(ngat, "DENSE_AUTO_SCORE_BYTES", pin)
        xi = x.clone().requires_grad_(mode == "train")
        with mock.patch.multiple(kg, **{n: spy(n) for n in plain}):
            if mode == "eval":
                with torch.no_grad():
                    outs[name] = (layer(xi), [])
            else:
                out = layer(xi, torch.Generator().manual_seed(0))
                grads = torch.autograd.grad((out * cot).sum(), [xi, *layer.parameters()])
                outs[name] = (out.detach(), grads)
        if name == "dense":
            assert called == []
    want = ["gatv2_attention_fwd_plain"] if mode == "eval" else [
        "gatv2_attention_res_plain", "gatv2_attention_bwd_plain"]
    assert called == want
    for n, count in launches.items():
        assert getattr(kg, n).launches == count, n
    torch.testing.assert_close(outs["routed"][0], outs["dense"][0], atol=1e-5, rtol=0)
    for gr, gd in zip(outs["routed"][1], outs["dense"][1]):
        torch.testing.assert_close(gr, gd, atol=1e-5, rtol=0)


def test_routed_training_takes_the_kernels_dropout_seed(monkeypatch):
    """At dropout 0.3 the routed layer draws one seed from the caller's
    generator and masks with the kernels' hash, as ``impl="pallas"`` does:
    the two layers give identical outputs from equal generators."""
    monkeypatch.setattr(ngat, "DENSE_AUTO_SCORE_BYTES", 1)
    kw = dict(n_features=5, window_size=9, embed_dim=6)
    routed = TemporalAttention(dropout=0.3, alpha=0.2,
                               generator=torch.Generator().manual_seed(2), **kw).train()
    fused = TemporalAttention(dropout=0.3, alpha=0.2, impl="pallas",
                              generator=torch.Generator().manual_seed(2), **kw).train()
    x = torch.randn(3, 9, 5, generator=torch.Generator().manual_seed(5))
    got = routed(x, torch.Generator().manual_seed(7))
    want = fused(x, torch.Generator().manual_seed(7))
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    assert (got - routed.eval()(x)).abs().max() > 1e-3
