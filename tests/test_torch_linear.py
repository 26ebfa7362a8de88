"""The wav2vec2 encoder's linear projections (``ops/linear.py``) and the
3xTF32 kernel under them (``ops/cuda/linear_3xtf32.cu``).

The CPU test holds the dispatcher's plain form to ``F.linear`` bit for bit
and the kernel wrapper's layout checks, which run before it looks at the
device. The ``card`` test needs a CUDA card and skips without one; this
file imports no JAX, so on the card it runs alone with
``python -m pytest tests/test_torch_linear.py -m card --noconftest``.
"""

import pytest
import torch
import torch.nn.functional as F
from torch import nn

from koemorph_tpu_torch.ops import cuda as ck
from koemorph_tpu_torch.ops import linear as lin


def test_plain_path_and_layout_checks():
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 9, 16, generator=gen)
    layers = [nn.Linear(16, 12) for _ in range(3)]
    for m in layers:
        for p in m.parameters():
            p.data.copy_(torch.randn(p.shape, generator=gen))
    with torch.no_grad():
        got = lin.linear(x, *layers)
        gelu = lin.linear(x, layers[0], gelu=True)[0]
    for y, m in zip(got, layers):
        assert torch.equal(y, F.linear(x, m.weight, m.bias))
    assert torch.equal(gelu, F.gelu(F.linear(x, layers[0].weight,
                                             layers[0].bias)))
    w = [m.weight.detach() for m in layers]
    b = [m.bias.detach() for m in layers]
    with pytest.raises(ValueError, match="contiguous"):
        ck.linear_3xtf32(x.transpose(0, 1), w, b)
    with pytest.raises(ValueError, match="contiguous"):
        ck.linear_3xtf32(x, [w[0].t().contiguous().t()], b[:1])
    with pytest.raises(ValueError, match="multiples of 4"):
        ck.linear_3xtf32(x[..., :14].contiguous(),
                         [w[0][:, :14].contiguous()], b[:1])
    with pytest.raises(ValueError, match="CUDA"):
        ck.linear_3xtf32(x, w, b)


#: (rows, features, K, weights sharing the input, GELU epilogue): the
#: encoder's products at one lane of 1,029 frames and at 8 lanes, and a
#: ragged row count; on an H100 they take every row tile between them
CARD_SHAPES = [(1029, 1024, 1024, 3, False), (1029, 1024, 1024, 1, False),
               (1029, 4096, 1024, 1, True), (1029, 1024, 4096, 1, False),
               (1029, 1024, 512, 1, False), (8232, 1024, 1024, 3, False),
               (8232, 4096, 1024, 1, True), (8232, 1024, 4096, 1, False),
               (37, 1024, 1024, 1, False), (37, 4096, 1024, 1, True)]


@pytest.mark.card
def test_kernel_against_float64_on_card():
    """K4 against ``x W^T + b`` in float64: its error within 4x of cuBLAS
    float32's own, and a plain TF32 product outside that; two launches
    give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    assert not torch.backends.cuda.matmul.allow_tf32
    tiles = set()
    for m, n, k, groups, gelu in CARD_SHAPES:
        x = torch.randn(m, k, device=dev, generator=gen)
        ws = [torch.randn(n, k, device=dev, generator=gen) / k ** 0.5
              for _ in range(groups)]
        bs = [0.02 * torch.randn(n, device=dev, generator=gen)
              for _ in range(groups)]

        def product(w, b):
            y = F.linear(x, w, b)
            return F.gelu(y) if gelu else y

        def worst(ys):
            err = 0.0
            for y, w, b in zip(ys, ws, bs):
                want = x.double() @ w.double().T + b.double()
                want = F.gelu(want) if gelu else want
                err = max(err, float((y.double() - want).abs().max()
                                     / want.abs().max()))
            return err

        cublas = worst([product(w, b) for w, b in zip(ws, bs)])
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            tf32 = worst([product(w, b) for w, b in zip(ws, bs)])
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        limit = 4.0 * cublas
        assert tf32 > limit, (m, n, k, tf32, limit)
        tiles.add(ck.linear_tile(m, n, k, groups))
        ys = ck.linear_3xtf32(x, ws, bs, gelu=gelu)
        again = ck.linear_3xtf32(x, ws, bs, gelu=gelu)
        err = worst(ys)
        assert err <= limit, (m, n, k, groups, gelu, err, limit)
        assert all(torch.equal(a, b) for a, b in zip(ys, again))
    if torch.cuda.get_device_properties(dev).multi_processor_count == 132:
        assert tiles == set(ck.LINEAR_TILES), tiles
