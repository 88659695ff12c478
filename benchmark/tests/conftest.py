"""CPU tests of the benchmark. Tests that need the card carry the `card`
marker and decide inside the test whether one is present."""

from __future__ import annotations

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card; skips on the CPU")


def tiny_config(c: dict, dtype: str = "float32") -> dict:
    """The configuration's layout at a width and depth the CPU runs in seconds."""
    c = copy.deepcopy(c)
    c.update(hidden_size=64, intermediate_size=96, num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
             head_dim=16, vocab_size=300, llm_input_size=64, llm_output_size=64, dtype=dtype)
    c["hift"].update(base_channels=32, f0_cond_channels=16)
    if c["family"] == "cosyvoice2":
        c["flow"].update(input_size=32, enc_heads=2, enc_ffn=48, enc_blocks=2, enc_up_blocks=1, decoder_channels=[32],
                         n_blocks=1, num_mid_blocks=2, num_heads=2, attention_head_dim=16)
    else:
        c["flow"]["pre_lookahead_channels"] = 32
        c["flow"]["dit"].update(dim=64, depth=2, heads=4, dim_head=16)
    return c


@pytest.fixture
def tiny_cell():
    """cv3.datagen_b16 at the tiny size: 2 batches of 4 short texts."""
    from benchmark.harness import Cell

    def make(dtype: str = "float32"):
        cell = Cell("cv3.datagen_b16")
        cell.config = tiny_config(cell.config, dtype)
        cell.spec["params"].update(text_vocab=300, batches=2, batch=4, text_median=4, text_min=2, text_max=8,
                                   instruct_tokens=3, prompt_tokens=10, check_sample=3)
        return cell

    return make


@pytest.fixture
def tiny_stream_cell():
    """A stream cell at the tiny size: 3 clients, short texts, 2 voices."""
    from benchmark.harness import Cell

    def make(name: str, dtype: str = "float32"):
        cell = Cell(name)
        cell.config = tiny_config(cell.config, dtype)
        p = cell.spec["params"]
        p.update(text_vocab=300, clients=3, requests_per_client=3, text_median=6, text_min=3, text_max=12,
                 prompt_text_tokens=3, prompt_tokens=10, voices=2, llm_width=3, check_sample=3)
        if "stream_width" in p:
            p["stream_width"] = 3
        return cell

    return make
