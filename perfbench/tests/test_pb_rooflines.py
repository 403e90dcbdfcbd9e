"""The kernel roofline readers report a share only where the traced
stretch's launches match its prefill programs one a layer: a planted
mismatch leaves the metric out."""
import json
import types

import pytest

from conftest import DATA
from harness import cli, counts, peaks, spec
from harness import trace as tr
from harness.serve_open_loop import Record


def _run(config_file, kernel, launches, per_launch_us=50.0):
    w = spec.widths(json.loads((DATA / config_file).read_text()))
    prompts = [40, 24, 64]
    records = [Record(rid=i, due=0.0, prompt_len=n, n_tokens=4, order=i)
               for i, n in enumerate(prompts)]
    device = [(f"void {kernel}_kernel<128>", i * 100.0, i * 100.0 + per_launch_us)
              for i in range(launches)]
    return types.SimpleNamespace(
        widths=w, records=records, prefill_ctx_before_on=[[0]],
        stretch_prefill_ctx=[[0, 0]], trace=tr.Trace(1.0, device, [], {}))


@pytest.mark.parametrize("metric,config_file,kernel", [
    ("k5_roofline", "qwen-small.json", "prefix_prefill"),
    ("k7_roofline", "mamba-small.json", "selective_scan"),
])
def test_roofline_only_where_launches_match(metric, config_file, kernel, capsys):
    read = cli.reader(metric).read
    layers = spec.widths(json.loads((DATA / config_file).read_text()))["layers"]
    good = _run(config_file, kernel, layers)            # one program of two rows
    share = read(good)
    rows = [(24, 0), (64, 0)]                           # the 2nd and 3rd requests
    if metric == "k5_roofline":
        bound = counts.bound_s(*counts.k5_launch(good.widths, rows), peaks.BF16_FLOPS)
    else:
        bound = counts.bound_s(*counts.k7_launch(good.widths, [t for t, _ in rows]),
                               peaks.FP32_FLOPS)
    assert share == pytest.approx(100.0 * bound * layers / (layers * 50e-6))
    for wrong in (layers - 1, layers + 1, 2 * layers):
        assert read(_run(config_file, kernel, wrong)) is None
        assert "expected" in capsys.readouterr().err
