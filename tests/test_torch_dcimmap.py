"""Provisioning: the port's architecture registry and GEMM workload
extraction equal the JAX reference's for every registered arch, and
``plan`` runs from an architecture name to a provisioned macro."""
import dataclasses

import pytest

pytest.importorskip("torch", reason="the PyTorch port's tests need torch")

from repro import configs as jconfigs
from repro.dcimmap import extract as jextract
from repro_torch import configs as tconfigs
from repro_torch.core.nsga2 import NSGA2Config
from repro_torch.core.precision import get as get_precision
from repro_torch.dcimmap import extract as textract
from repro_torch.dcimmap import plan as tplan


def test_same_registry():
    assert tconfigs.ARCH_NAMES == jconfigs.ARCH_NAMES
    assert {k: dataclasses.asdict(v) for k, v in tconfigs.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()
    }


@pytest.mark.parametrize("arch", jconfigs.ARCH_NAMES)
def test_configs_and_extract_match_reference(arch):
    for get in ("get_config", "get_smoke_config"):
        tc, jc = getattr(tconfigs, get)(arch), getattr(jconfigs, get)(arch)
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        assert tc.layer_kinds() == jc.layer_kinds() and tc.hd == jc.hd
        tw, jw = textract(tc), jextract(jc)
        assert tw.arch == jw.arch and tw.unmappable == jw.unmappable
        assert [dataclasses.asdict(g) for g in tw.gemms] == [dataclasses.asdict(g) for g in jw.gemms]
        assert tw.total_weights() == jw.total_weights()
        assert tw.macs_per_token() == jw.macs_per_token()


def test_plan_provisions_an_architecture():
    mp = tplan("qwen2.5-3b", precision=["int8", "bf16"], w_store=[16384, 65536],
               cfg_nsga=NSGA2Config(pop_size=32, generations=8), device="cpu")
    assert mp.precision in ("int8", "bf16") and mp.n_macros > 0
    assert mp.total_area_mm2 > 0 and mp.tokens_per_s > 0
    wl = textract(tconfigs.get_config("qwen2.5-3b"))
    p = mp.point
    w_store = p.N * p.H * p.L // get_precision(mp.precision).B_w
    assert w_store == p.w_store
    assert mp.n_macros == -(-wl.total_weights() // w_store)
