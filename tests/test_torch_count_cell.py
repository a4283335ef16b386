"""``launch.analysis.count_cell`` on the CPU: it counts a cell's step at
2 and 3 super-blocks (and, in a train step, 2 and 3 micro-batches) and
extrapolates. On the reduced configs of every family at 4 blocks and 4
micro-batches (``tests/test_torch_dryrun.py``'s cells), every count it
gives equals the count of the whole step, exactly: FLOPs, bytes, ops and
the peak of live bytes, and the model's parameters.
"""
import pytest
import torch

from repro_torch.launch import analysis, specs
from test_torch_dryrun import FAMILIES, _cfg, small  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as the other LM test files. Restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("kind", ["prefill_32k", "decode_32k", "train_4k"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_count_cell_equals_the_whole_step_counted(small, family, kind):
    arch = FAMILIES[family]
    cell = specs.build_cell(arch, kind, cfg=_cfg(arch))
    _, whole = analysis.analyze(cell.fn, *cell.args, roots=cell.roots)
    counted = analysis.count_cell(arch, kind, cfg=_cfg(arch))
    for key in ("dot_flops", "other_flops", "hbm_bytes", "n_ops",
                "peak_live_bytes"):
        assert counted["analysis"][key] == whole[key], key
    assert counted["param_count"] == sum(
        p.numel() for p in cell.model.parameters())
    probes = {(p["blocks"], p.get("micro_batches")) for p in
              counted["probes"]}
    micro = (2, 3) if kind == "train_4k" else (None,)
    assert probes == {(n, g) for n in (2, 3) for g in micro}
    assert counted["meta"]["blocks"] == 4
