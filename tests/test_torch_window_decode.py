"""The sliding-window ring cache decoded through the dense decode path,
against the JAX reference, on the CPU.

The ring holds position p in slot p % W (W = min(cache_len, window) <=
window), so once it has wrapped every slot holds one of the last W
positions.  Attention does not depend on the order of the keys: the port
decodes the ring as the dense form over its first min(pos + 1, W) slots
(``repro_torch.models.layers.decode_attention``), the reference masks the
ring by each slot's position (``repro.models.layers.decode_attention``).
Slots not yet written hold noise, which the mask must hide.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.models import layers as JL  # noqa: E402
from repro_torch import kernels as K  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402

TOL = 1e-5    # fp32; the two sum the softmax in other orders
B, H, HKV, HD = 2, 4, 2, 16


def _inputs(rng, W):
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return f(B, 1, H, HD), f(B, W, HKV, HD), f(B, W, HKV, HD)


@pytest.mark.parametrize("W,window", [(8, 8), (8, 12)])
@pytest.mark.parametrize("pos", [[0, 3], [6, 7], [8, 13], [21, 40]],
                         ids=["filling", "full", "wrapped", "wrapped-twice"])
def test_ring_decode_matches_reference(monkeypatch, W, window, pos):
    rng = np.random.default_rng(W + window + sum(pos))
    q, kc, vc = _inputs(rng, W)
    p = np.array(pos, np.int32)
    seen = []
    dense = K.decode_attention

    def spy(q_, k_, v_, lengths, **kw):
        seen.append(lengths.tolist())
        return dense(q_, k_, v_, lengths, **kw)
    monkeypatch.setattr(K, "decode_attention", spy)
    got = L.decode_attention(*(torch.from_numpy(x) for x in (q, kc, vc, p)),
                             window=window)
    want = JL.decode_attention(*(jnp.asarray(x) for x in (q, kc, vc, p)),
                               window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    assert seen == [[min(x + 1, W) for x in pos]]   # the dense path


def test_ring_wider_than_the_window_is_refused():
    q, kc, vc = _inputs(np.random.default_rng(0), 16)
    with pytest.raises(ValueError, match="exceeds the window"):
        L.decode_attention(*(torch.from_numpy(x) for x in (q, kc, vc)),
                           torch.tensor([3, 20], dtype=torch.int32), window=8)
