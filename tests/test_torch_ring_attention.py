"""The port's ring attention against the JAX package's, on gloo ranks.

One spawned group of S CPU ranks a parametrisation (S = 2 and 4, the
model axis of ``make_mesh(S, model_parallel=S)``), each group running every
case, against ``mtad_gat_tpu.parallel.ring_attention.ring_gatv2_attention``
on the JAX package's 8-device CPU farm with the same mesh shape, from the
same numpy inputs:

- N 32, 30 and 33 (divisible by S, and padded), with and without a score
  bias: every rank's output within 2e-5 of the JAX ring's (the JAX test's
  own ``atol``, ``tests/test_ring_attention.py``);
- the gradients of sum(out * cot) w.r.t. p, q, a, bias and v, each rank's
  part summed over the model axis (as ``copy_to_model`` and the trainer
  sum them), within 1e-5 of ``jax.grad`` of the JAX ring;
- at dropout 0.3 every rank's output equals the port's plain K1-res
  (``kernels.gat.gatv2_attention_res_plain``) at the same seed within 2e-5:
  the ring's mask is the kernels' hash over global (batch, row, column).

Each group has a deadline: past it the ranks are killed and the test fails.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtad_gat_tpu.parallel import make_mesh as jax_make_mesh
from mtad_gat_tpu.parallel.ring_attention import ring_gatv2_attention as jax_ring
from mtad_gat_tpu_torch.kernels.gat import gatv2_attention_res_plain
from mtad_gat_tpu_torch.parallel import multihost
from tests.torch_mesh_ranks import ring_rank

torch.set_num_threads(1)

ALPHA, RATE, SEED = 0.2, 0.3, 1234
CASES = [(n, with_bias) for n in (32, 30, 33) for with_bias in (True, False)]
DEADLINE = 120.0


def _case(n, with_bias, b=2, e=8, d=6):
    rng = np.random.default_rng(n + 100 * with_bias)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)  # noqa: E731
    return dict(p=f(b, n, e), q=f(b, n, e), a=f(e), bias=0.2 * f(n, n) if with_bias else None,
                v=f(b, n, d), cot=f(b, n, d))


def _jax_ring(c, mesh):
    names = [k for k in ("p", "q", "a", "bias", "v") if c[k] is not None]

    def loss(*xs):
        kw = dict(zip(names, xs))
        out = jax_ring(kw["p"], kw["q"], kw["a"], kw.get("bias"), kw["v"], ALPHA, mesh)
        return jnp.sum(out * c["cot"]), out

    (_, out), grads = jax.jit(jax.value_and_grad(loss, argnums=tuple(range(len(names))),
                                                 has_aux=True))(*[jnp.asarray(c[k])
                                                                  for k in names])
    return np.asarray(out), {k: np.asarray(g) for k, g in zip(names, grads)}


@pytest.mark.parametrize("shards", [2, 4])
def test_ring_matches_the_jax_ring_and_k1res(shards, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")      # one thread a rank
    cases = [_case(n, with_bias) for n, with_bias in CASES]
    mesh = jax_make_mesh(shards, model_parallel=shards)
    jax_results = []
    jax_thread = threading.Thread(   # the JAX ring compiles while the ranks run
        target=lambda: jax_results.extend(_jax_ring(c, mesh) for c in cases))
    jax_thread.start()
    try:
        every = multihost.spawn(shards, ring_rank, (cases, ALPHA, RATE, SEED),
                                deadline=DEADLINE)
    finally:
        jax_thread.join(timeout=DEADLINE)
    assert not jax_thread.is_alive() and len(every) == shards
    for (n, with_bias), c, (want, want_grads), *per_rank in zip(CASES, cases, jax_results,
                                                                *every):
        plain = gatv2_attention_res_plain(
            *(None if c[k] is None else torch.from_numpy(c[k])
              for k in ("p", "q", "a", "bias", "v")), ALPHA, SEED, RATE)[0].numpy()
        for rank, (out, grads, dropped) in enumerate(per_rank):
            tag = f"N {n}, bias {with_bias}, rank {rank} of {shards}"
            np.testing.assert_allclose(out, want, atol=2e-5, err_msg=tag)
            assert set(grads) == set(want_grads)
            for k, g in grads.items():
                np.testing.assert_allclose(g, want_grads[k], atol=1e-5, err_msg=f"d{k}, {tag}")
            np.testing.assert_allclose(dropped, plain, atol=2e-5, err_msg=f"rate 0.3, {tag}")
            assert not np.allclose(dropped, out, atol=1e-3), tag
