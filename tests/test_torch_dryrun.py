"""The port's dry-run (``launch.specs``, ``launch.analysis``,
``launch.dryrun``, ``launch.contrib``) on the CPU.

Its count runs a cell's step on meta tensors. Held here:
- on reduced configs of every family (dense, MoE, RWKV, hybrid, XATTN,
  encoder-decoder) cut to 4 blocks, the matrix-product FLOPs counted on
  meta equal ``FlopCounterMode``'s count of the same step run for real on
  the CPU, exactly: prefill, decode and train (4 micro-batches). The
  sequences are long enough, and the query chunk short enough, that every
  loop the count runs as three passes (``repro_torch.loop``: the query
  chunks, the scan's and the WKV's chunks and positions) has more than
  three (``tests/test_torch_count_cell.py`` holds ``count_cell``'s
  extrapolation to the same steps);
- a checkpointed block's count keeps less alive than an unchecked one;
- ``roofline_terms`` as the reference's test, at the card's rates;
- the CLI in-process on a reduced cell (an ``ok`` record), ``long_500k``
  on a dense arch (``skipped``, the reference's reason), ``--mesh
  multi`` (module 8), ``contrib``'s rows, and that meta tensors reach no
  kernel build or launch.
"""
import dataclasses
import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import base as ref_base
from repro_torch import _loop, loop
from repro_torch.configs import base
from repro_torch.kernels import build
from repro_torch.kernels.accgrad_reduce import ops as accgrad_ops
from repro_torch.kernels.decode_attn import kernel as dk
from repro_torch.kernels.decode_attn import ops as decode_attn_ops
from repro_torch.kernels.mbcodec import ops as mbcodec_ops
from repro_torch.kernels.wkv6 import kernel as wk
from repro_torch.kernels.wkv6 import ops as wkv6_ops
from repro_torch.launch import analysis, contrib, dryrun, specs
from repro_torch.models import layers

FAMILIES = {"dense": "yi_34b", "moe": "olmoe_1b_7b", "rwkv": "rwkv6_1b6",
            "hybrid": "jamba1_5_large_398b", "xattn": "llama3_2_vision_90b",
            "encdec": "seamless_m4t_large_v2"}
# the workload shapes at a CPU test's size: 4 sequence chunks of 32 (the
# WKV's and the scan's), 4 query chunks of SMALL_Q_CHUNK, 4 micro-batches
SMALL = {"train_4k": base.ShapeSpec("train_4k", 128, 4, "train"),
         "prefill_32k": base.ShapeSpec("prefill_32k", 128, 2, "prefill"),
         "decode_32k": base.ShapeSpec("decode_32k", 64, 2, "decode"),
         "long_500k": base.ShapeSpec("long_500k", 128, 1, "decode")}
SMALL_Q_CHUNK = 32
BLOCKS, ACCUM = 4, 4
# the sublayers kept of a long block pattern: jamba's (MAMBA, MOE) and
# (ATTN, MLP), llama-vision's last (ATTN, MLP) and its (XATTN, MLP)
KEEP = {"jamba1_5_large_398b": (1, 4), "llama3_2_vision_90b": (3, 4)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as the other LM test files (the suite's
    workers share the machine's cores). Restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def small(monkeypatch):
    """The small shapes, the short query chunk, and ``get_config`` giving
    the reduced configs (for the CLI)."""
    for name, shape in SMALL.items():
        monkeypatch.setitem(base.SHAPES, name, shape)
    monkeypatch.setattr(layers, "Q_CHUNK", SMALL_Q_CHUNK)
    monkeypatch.setattr(base, "get_config", base.get_reduced_config)


def _cfg(arch):
    """The reduced config at BLOCKS blocks (of the KEEP sublayers) and
    ACCUM micro-batches."""
    cfg = base.get_reduced_config(arch)
    pattern = tuple(cfg.block_pattern[i] for i in KEEP.get(
        arch, range(len(cfg.block_pattern))))
    return dataclasses.replace(cfg, block_pattern=pattern,
                               n_layers=BLOCKS * len(pattern),
                               grad_accum=ACCUM)


@pytest.mark.parametrize("kind", ["prefill_32k", "decode_32k", "train_4k"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_meta_count_equals_a_real_cpu_run(small, family, kind):
    arch = FAMILIES[family]
    cell = specs.build_cell(arch, kind, cfg=_cfg(arch))
    _, ana = analysis.analyze(cell.fn, *cell.args, roots=cell.roots)
    real = specs.build_cell(arch, kind, cfg=_cfg(arch), device="cpu")
    with FlopCounterMode(display=False) as counter:
        real.fn(*real.args)
    assert ana["dot_flops"] == counter.get_total_flops() > 0
    assert ana["flops"] == ana["dot_flops"] + ana["other_flops"]
    params = sum(p.numel() * p.element_size()
                 for p in cell.model.parameters())
    assert ana["peak_live_bytes"] >= params
    assert ana["hbm_bytes"] > params // 4 and ana["n_ops"] > 0
    assert ana["collective_wire_bytes"] == 0.0


def _passes(run_loop, grad):
    """A loop of 6 passes carrying a state through a matrix product and
    keeping each pass's output, under ``analyze``."""
    w = torch.empty(64, 64, device="meta", requires_grad=grad)
    x0 = torch.empty(8, 64, device="meta")

    def body(i, h):
        h = torch.tanh(h @ w)
        return h * 2, h

    def step():
        outs, h = run_loop(body, range(6), x0)
        y = torch.cat(outs).sum() + h.sum()
        if grad:
            y.backward()
        return y

    return analysis.analyze(step, roots=(w, x0))[1]


@pytest.mark.parametrize("grad", [False, True])
def test_a_loop_counts_as_the_passes_it_stands_for(grad):
    """``repro_torch.loop`` runs 3 of the 6 passes under the count and
    counts the middle one 4 times, its backward too: the same FLOPs,
    bytes and ops as the 6 passes run one by one; without autograd also
    the same peak (the passes' outputs held 6 times over)."""
    counted, plain = _passes(loop, grad), _passes(_loop, grad)
    for key in ("dot_flops", "other_flops", "hbm_bytes", "n_ops"):
        assert counted[key] == plain[key], key
    if not grad:
        assert counted["peak_live_bytes"] == plain["peak_live_bytes"]
    # a product a pass, and in the backward two (dh, dw) but the first's
    products = 3 * 6 - 1 if grad else 6
    assert counted["dot_flops"] == products * 2 * 8 * 64 * 64


def test_a_checkpointed_block_keeps_less_alive():
    """remat "full" recomputes each block in the backward: the counted
    peak of a train step is lower than with every activation kept (the
    module paths are taken from forward hooks alone, which hold no
    tensor)."""
    peaks = {}
    for remat in ("full", "none"):
        cfg = dataclasses.replace(_cfg("yi_34b"), remat=remat)
        cell = specs.build_cell("yi_34b", "train_4k", cfg=cfg)
        peaks[remat] = analysis.analyze(
            cell.fn, *cell.args, roots=cell.roots)[1]["peak_live_bytes"]
    assert peaks["full"] < peaks["none"]


def test_analyze_refuses_tensors_off_meta():
    with pytest.raises(ValueError, match="meta"):
        analysis.analyze(torch.sum, torch.ones(3))
    with pytest.raises(ValueError, match="meta"):
        analysis.analyze(torch.sum, torch.empty(3, device="meta"),
                         roots=(torch.ones(3),))


def test_peak_counts_storages_alive_at_once():
    x = torch.empty(1024, device="meta")  # 4 KB

    def step():
        a = x * 2          # 4 KB alive beside x
        b = torch.cat([a, a])  # 8 KB: 16 KB at once
        del a
        return b.sum()

    ana = analysis.analyze(step, roots=(x,))[1]
    assert ana["peak_live_bytes"] == 4096 * 4
    assert ana["dot_flops"] == 0 and ana["hbm_bytes"] > 0


def test_roofline_terms_and_bottleneck_at_the_cards_rates():
    """As the reference's test, at the H100's dense bf16 rate and HBM3
    bandwidth."""
    terms = analysis.roofline_terms(
        {"dot_flops": 989.4e12, "hbm_bytes": 3.35e12 / 2,
         "collective_wire_bytes": 0.0})
    assert terms["compute_s"] == pytest.approx(1.0)
    assert terms["memory_s"] == pytest.approx(0.5)
    assert terms["collective_s"] == 0.0
    assert terms["bottleneck"] == "compute"
    assert terms["step_time_lower_bound_s"] == pytest.approx(1.0)
    assert (analysis.H100_BF16_FLOP_PER_S, analysis.H100_HBM_BYTES_PER_S) \
        == (989.4e12, 3.35e12)


def test_cli_in_process_writes_an_ok_record(small, tmp_path, capsys):
    dryrun.main(["--arch", "smollm_360m", "--shape", "decode_32k",
                 "prefill_32k", "--in-process", "--device", "cpu", "--out",
                 str(tmp_path)])
    assert "[ok] smollm_360m__decode_32k__single" in capsys.readouterr().out
    for shape in ("decode_32k", "prefill_32k"):
        rec = json.loads((tmp_path / f"smollm_360m__{shape}__single.json")
                         .read_text())
        assert rec["status"] == "ok" and rec["fits"] is True
        assert rec["card"]["name"] == "NVIDIA H100 80GB HBM3"
        assert rec["roofline"]["step_time_lower_bound_s"] > 0
        assert rec["counted_flops_global"] == rec["analysis"]["dot_flops"]
        assert rec["model_flops_global"] == specs.model_flops(
            base.get_reduced_config("smollm_360m"), SMALL[shape])
        assert rec["param_count"]["analytic"] == \
            base.get_reduced_config("smollm_360m").param_count()
        assert rec["memory"]["peak_live_bytes"] >= \
            rec["memory"]["param_bytes"] + rec["memory"]["cache_bytes"]
        assert "eager" in rec["meta"]["step"]
        assert rec["meta"]["blocks"] == 2 and rec["counted_at"] == [
            {"blocks": 2, "weight": 1}]
    cfg, shape = base.get_reduced_config("smollm_360m"), SMALL["decode_32k"]
    rec = json.loads((tmp_path / "smollm_360m__decode_32k__single.json")
                     .read_text())
    assert rec["memory"]["cache_bytes"] == (
        2 * cfg.n_layers * shape.global_batch * shape.seq_len
        * cfg.n_kv_heads * cfg.hd * 2)  # bf16 K and V of every layer


def test_long_500k_on_a_dense_arch_is_skipped_with_the_reference_reason(
        tmp_path):
    dryrun.main(["--arch", "smollm_360m", "--shape", "long_500k",
                 "--device", "cpu", "--out", str(tmp_path)])
    rec = json.loads((tmp_path / "smollm_360m__long_500k__single.json")
                     .read_text())
    want = ref_base.cell_applicable(ref_base.get_config("smollm_360m"),
                                    ref_base.SHAPES["long_500k"])
    assert rec["status"] == "skipped"
    assert (False, rec["skip_reason"]) == want


def test_multi_pod_mesh_raises_naming_module_8():
    with pytest.raises(NotImplementedError, match="module 8"):
        dryrun.main(["--arch", "smollm_360m", "--shape", "decode_32k",
                     "--mesh", "multi", "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="module 8"):
        contrib.main(["--arch", "smollm_360m", "--shape", "decode_32k",
                      "--mesh", "multi", "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="module 8"):
        specs.build_cell("smollm_360m", "decode_32k", mesh="multi")


def test_contrib_prints_its_rows(small, capsys):
    contrib.main(["--arch", "smollm_360m", "--shape", "prefill_32k",
                  "--top", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    for title in ("== top HBM bytes", "== top collectives (total 0.0 GB)",
                  "== top dot FLOPs"):
        assert title in out
    flops = out.split("== top dot FLOPs")[1].strip().splitlines()[1:]
    assert len(flops) == 3 and all("aten." in line for line in flops)
    assert any("Stack.blocks" in line for line in flops)


def test_meta_tensors_reach_no_kernel_build_or_launch(small, monkeypatch):
    """Every kernel of the port on meta tensors takes its plain version:
    no build, no load, no launch, the launch counts unchanged."""
    def refuse(*args, **kwargs):
        raise AssertionError("a meta tensor reached a CUDA kernel")

    for mod, names in ((build, ("build", "load")),
                       (decode_attn_ops, ("decode_attn_cuda",)),
                       (wkv6_ops, ("wkv6_cuda",)),
                       (accgrad_ops, ("accgrad_reduce_cuda",)),
                       (mbcodec_ops, ("mbcodec_chunk_cuda",
                                      "mbcodec_chunk_scores_cuda",
                                      "mbcodec_frame_cuda"))):
        for name in names:
            monkeypatch.setattr(mod, name, refuse)
    before = (dict(dk.LAUNCHES), dict(wk.LAUNCHES))
    for arch, shape in (("smollm_360m", "decode_32k"),
                        ("rwkv6_1b6", "prefill_32k"),
                        ("rwkv6_1b6", "long_500k"),
                        ("rwkv6_1b6", "train_4k"),
                        ("jamba1_5_large_398b", "decode_32k")):
        analysis.count_cell(arch, shape)
    meta = torch.device("meta")
    g = torch.empty((2, 32, 48, 3), device=meta)
    assert accgrad_ops.accgrad_reduce(g, g, g).shape == (2, 2, 3)
    blocks = torch.empty((3, 16, 16), device=meta)
    rec, bits = mbcodec_ops.mbcodec(blocks, torch.empty(3, device=meta))
    assert rec.device == meta and rec.shape == blocks.shape
    assert (dict(dk.LAUNCHES), dict(wk.LAUNCHES)) == before
