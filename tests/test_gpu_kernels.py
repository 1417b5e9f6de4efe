"""The compiled kernels against the plain reference at real widths, on an
NVIDIA GPU. These skip without one; run them on the card with

    python -m pytest -m gpu tests/

chip_smoke.py's kernel phase runs the same checks (and times them).
"""
import pytest

import chip_smoke
from gemma_tpu.models import GEMMA_2B, GEMMA_7B
from gemma_tpu.ops.quant_matmul import KERNEL_MAX_M

pytestmark = [pytest.mark.gpu, pytest.mark.usefixtures("gpu")]

SHAPES = [
    (model, name, shape)
    for model, cfg in (("2b", GEMMA_2B), ("7b", GEMMA_7B))
    for name, shape in chip_smoke.projection_shapes(cfg).items()
]


@pytest.mark.parametrize("fmt", ["q4_0", "q8_0", "q4_k", "q6_k"])
@pytest.mark.parametrize("model,name,shape", SHAPES, ids=[f"{m}-{n}" for m, n, _ in SHAPES])
@pytest.mark.parametrize("m", [chip_smoke.DECODE_M, KERNEL_MAX_M])
def test_quant_matmul_compiled(fmt, model, name, shape, m):
    res = chip_smoke.check_matmul(fmt, *shape, m, timing=False)
    assert res["ok"], res


@pytest.mark.parametrize("case", chip_smoke.default_attention_cases(),
                         ids=lambda c: f"{c['mode'] if 'mode' in c else 'bf16'}-S{c['S']}-H{c['Hq']}/{c['Hkv']}-{c['limits']}")
def test_decode_attention_compiled(case):
    res = chip_smoke.check_decode_attention(**{**case, "timing": False})
    assert res["ok"], res
