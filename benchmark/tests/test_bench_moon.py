"""The MLA-MoE cell (cv3moon.datagen_b16): its yardstick, its metrics'
readers, and whole runs with the timed path broken underneath. On the CPU
at a tiny size (the look for a card skipped): the sound program is
correct, and each planted fault of the router comes out not correct. On
the card (`-m card`) at the cell's own size: the same faults, and the
sound program correct on a seed of its own.

    python -m pytest benchmark/tests/test_bench_moon.py
    python -m pytest benchmark/tests/test_bench_moon.py -m card   # on an NVIDIA card
"""

from __future__ import annotations

import copy

import pytest
import torch
import torch.nn.functional as F

from benchmark.metrics import counters, counters_moe
from benchmark.run import run_cell

CELL = "cv3moon.datagen_b16"
SEED = 2**31 + 91


def tiny_moon_config(c: dict) -> dict:
    c = copy.deepcopy(c)
    c.update(hidden_size=64, intermediate_size=96, moe_intermediate_size=32, num_hidden_layers=4, num_attention_heads=4,
             kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16, n_routed_experts=8,
             num_experts_per_tok=4, n_shared_experts=1, vocab_size=300, llm_input_size=64, llm_output_size=64,
             dtype="float32")
    c["hift"].update(base_channels=32, f0_cond_channels=16)
    c["flow"]["pre_lookahead_channels"] = 32
    c["flow"]["dit"].update(dim=64, depth=2, heads=4, dim_head=16)
    return c


@pytest.fixture
def tiny_moon_cell():
    from benchmark.harness import Cell

    cell = Cell(CELL)
    cell.config = tiny_moon_config(cell.config)
    cell.spec["params"].update(text_vocab=300, batches=2, batch=4, text_median=4, text_min=2, text_max=8,
                               instruct_tokens=3, prompt_tokens=10, check_sample=3)
    # the tiny float32 model's logits are nearly flat and its decode's bf16 cache moves them by about 1e-4, so
    # the LM limits of the full-size cell (set by bf16's expert flips over 27 layers) would pass anything here
    cell.spec["limits"].update(lm_gap=0.01, lm_gap_mean=0.0005)
    return cell


def _route(self, x, next_for_last: bool = False, normalize: bool = True):
    """models/mla_moe.MoE.route with a planted fault: each row's last chosen
    expert replaced by the next one in order (the 6th by the 7th at k = 6),
    or the weights left unnormalized."""
    c = self.cfg
    k = c.num_experts_per_tok
    scores = torch.sigmoid(F.linear(x.float(), self.gate.weight.float()))
    top = torch.topk(scores + self.gate.e_score_correction_bias.float(), k + 1, dim=-1).indices
    chosen = torch.cat([top[:, : k - 1], top[:, k:]], dim=1) if next_for_last else top[:, :k]
    w = scores.gather(1, chosen)
    if normalize:
        w = w / (w.sum(dim=-1, keepdim=True) + 1e-20)
    return chosen, w * c.routed_scaling_factor


FAULTS = {
    "next_expert_for_last": lambda self, x: _route(self, x, next_for_last=True),
    "unnormalized_weights": lambda self, x: _route(self, x, normalize=False),
}


def _run(cell, device, seconds, monkeypatch=None, fault=None, seed=SEED):
    if fault is not None:
        from fangyan_tts_torch.models import mla_moe

        monkeypatch.setattr(mla_moe.MoE, "route", FAULTS[fault])
    return run_cell(cell, seed, seconds, False, device, 0.0)


def test_sound_program_is_correct(tiny_moon_cell):
    r = _run(tiny_moon_cell, torch.device("cpu"), 0.5)
    assert r["failed"] == 0 and r["attempted"] >= 4
    assert all(v["value"] <= v["limit"] for v in r["check"].values()), r["check"]
    assert r["correct"]


def test_sound_route_is_the_program_route(tiny_moon_cell):
    """The planted faults' own route, without a fault, is the program's."""
    from fangyan_tts_torch.config import MLAMoEConfig
    from fangyan_tts_torch.models.mla_moe import MoE

    m = MoE(MLAMoEConfig(hidden_size=64, moe_intermediate_size=32, n_routed_experts=8, num_experts_per_tok=4))
    torch.nn.init.normal_(m.gate.weight)
    torch.nn.init.normal_(m.gate.e_score_correction_bias, std=0.1)
    x = torch.randn(11, 64)
    got, want = _route(m, x), m.route(x)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("fault", list(FAULTS))
def test_planted_fault_is_not_correct(tiny_moon_cell, monkeypatch, fault):
    r = _run(tiny_moon_cell, torch.device("cpu"), 0.5, monkeypatch, fault)
    assert not r["correct"] and r["check"]["lm_gap_mean"]["value"] > r["check"]["lm_gap_mean"]["limit"], r["check"]


def test_moe_yardstick():
    """The expert kernel's bytes at Moonlight's widths: 17.30 MB an expert;
    a decode phase of one call touching 51 experts with 96 routed rows is
    bound by its bytes."""
    from benchmark.harness import HERE, read_json

    c = read_json(HERE / "configs" / "cosyvoice3-moonlight-16b-a3b.json")
    assert counters_moe.expert_bytes(c) == 17_301_504
    nbytes, ops = counters_moe.moe_phase_work(c, 51, 96)
    assert counters.bound(nbytes, ops)[1] == "bytes"
    counts = {"moe.calls.decode": 1, "moe.active_experts.decode": 51, "moe.routed_rows.decode": 96}
    assert counters_moe.moe_least_ms(c, counts) == pytest.approx(nbytes / counters.HBM_BYTES_PER_S * 1e3)
    assert counters_moe.moe_least_ms(c, {}) is None
    pre = counters_moe.moe_phase_work(c, 64, 96 * 96)  # a 1.5 k-row prefill call
    assert counters.bound(*pre)[1] == "bytes"
    nb, op = counters_moe.mla_decode_work(16, 512, 16, 512, 64, 16 * 300)
    assert nb == 16 * 300 * 1152 + 16 * 16 * 576 * 2 + 16 * 16 * 512 * 2 + 16 * 512 * 4
    assert op == 2 * 16 * 1088 * 16 * 300


@pytest.mark.card
@pytest.mark.parametrize("fault", [None, *FAULTS])
def test_card_faults(monkeypatch, fault):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from benchmark.harness import Cell

    r = _run(Cell(CELL), torch.device("cuda"), 10.0, monkeypatch, fault, seed=SEED + (7 if fault else 0))
    print(fault, r["check"])
    if fault is None:
        assert r["correct"], r["check"]
    else:
        assert not r["correct"] and r["check"]["lm_gap_mean"]["value"] > r["check"]["lm_gap_mean"]["limit"], r["check"]
