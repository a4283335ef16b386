"""The port's workload shapes and analytic counts against the reference:
``SHAPES``, ``cell_applicable`` with its reasons, ``param_count``,
``active_param_count`` and ``model_flops`` equal the reference's exactly,
for every arch (all 10 load in both packages) and every shape. These are
integers and strings: nothing runs a model."""
import dataclasses

import pytest

from repro.configs import base as ref_base
from repro.launch import specs as ref_specs
from repro_torch.configs import base
from repro_torch.launch import specs

CELLS = [(a, s) for a in ref_base.ARCH_IDS for s in ref_base.SHAPES]


def test_arch_ids_and_shapes_match_reference():
    assert base.all_arch_ids() == ref_base.all_arch_ids()
    assert len(base.all_arch_ids()) == 10
    assert base.PUBLIC_IDS == ref_base.PUBLIC_IDS
    assert list(base.SHAPES) == list(ref_base.SHAPES)
    for name, shape in ref_base.SHAPES.items():
        mine = base.SHAPES[name]
        assert dataclasses.asdict(mine) == dataclasses.asdict(shape)
        assert mine.tokens == shape.tokens


@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_applicable_matches_reference(arch, shape):
    assert base.cell_applicable(base.get_config(arch), base.SHAPES[shape]) \
        == ref_base.cell_applicable(ref_base.get_config(arch),
                                    ref_base.SHAPES[shape])


def test_32_of_40_cells_run():
    """long_500k runs for the sub-quadratic archs only (rwkv6, jamba);
    every skip gives the reference's reason, naming the arch."""
    run = [(a, s) for a, s in CELLS
           if base.cell_applicable(base.get_config(a), base.SHAPES[s])[0]]
    assert len(CELLS) == 40 and len(run) == 32
    for a, s in CELLS:
        ok, why = base.cell_applicable(base.get_config(a), base.SHAPES[s])
        assert ok == (s != "long_500k" or a in ("rwkv6_1b6",
                                                "jamba1_5_large_398b"))
        assert ok or (base.get_config(a).name in why
                      and "see DESIGN.md" in why)


@pytest.mark.parametrize("arch", ref_base.ARCH_IDS)
def test_param_counts_match_reference(arch):
    mine, ref = base.get_config(arch), ref_base.get_config(arch)
    assert mine.param_count() == ref.param_count()
    assert mine.active_param_count() == ref.active_param_count()
    assert mine.param_count() >= mine.active_param_count() > 0
    mine_r, ref_r = base.get_reduced_config(arch), \
        ref_base.get_reduced_config(arch)
    assert mine_r.param_count() == ref_r.param_count()
    assert mine_r.active_param_count() == ref_r.active_param_count()


@pytest.mark.parametrize("arch,shape", CELLS)
def test_model_flops_match_reference(arch, shape):
    assert specs.model_flops(base.get_config(arch), base.SHAPES[shape]) \
        == ref_specs.model_flops(ref_base.get_config(arch),
                                 ref_base.SHAPES[shape])


@pytest.mark.parametrize("arch", ref_base.ARCH_IDS)
def test_seq_lens_match_reference(arch):
    """The enc-dec split of each cell's token budget."""
    for shape in ref_base.SHAPES:
        assert specs._seq_lens(base.get_config(arch), base.SHAPES[shape]) \
            == ref_specs._seq_lens(ref_base.get_config(arch),
                                   ref_base.SHAPES[shape])
