"""A copy of the benchmark in a temporary root with two tiny cells added
as files (a MoE transformer and a Mamba hybrid, float32, on the CPU), and
a third (a MoE with a shared expert) that ``add_shared`` adds the same
way."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
CELLS = ("tiny-moe-cell", "tiny-hybrid-cell")
LIMIT = 1e-3      # float32 plain path against the float32 reference

CONFIGS = {
    "tiny-moe": {"name": "tiny-moe", "engine": {"n_bo": 2, "mb_slots": 2,
                                                 "prefill_chunk": 8},
                 "port": {"name": "tiny-moe", "family": "moe", "n_layers": 2,
                          "d_model": 64, "n_heads": 4, "n_kv_heads": 2,
                          "d_head": 16, "d_ff": 0, "vocab_size": 256,
                          "n_experts": 8, "top_k": 4, "moe_d_ff": 32,
                          "tie_embeddings": True, "dtype": "float32",
                          "param_dtype": "float32"}},
    "tiny-hybrid": {"name": "tiny-hybrid",
                    "engine": {"n_bo": 2, "mb_slots": 2, "prefill_chunk": 8},
                    "port": {"name": "tiny-hybrid", "family": "hybrid",
                             "n_layers": 8, "d_model": 64, "n_heads": 4,
                             "n_kv_heads": 2, "d_head": 16, "d_ff": 128,
                             "vocab_size": 256, "n_experts": 4, "top_k": 2,
                             "moe_d_ff": 128, "moe_layer_offset": 1,
                             "moe_layer_period": 2, "attn_layer_offset": 4,
                             "attn_layer_period": 8, "ssm_state": 8,
                             "ssm_head_dim": 16, "use_rope": False,
                             "dtype": "float32", "param_dtype": "float32"}},
}
MIX = {"name": "tiny", "block": 8,
       "phases": [{"duration": 100.0, "rate": 20.0}],
       "prompt_len": {"lo": 4, "hi": 12, "long_lo": 17, "long_hi": 20,
                      "p_long": 0.2},
       "output_len": {"lo": 2, "hi": 6}, "warmup_s": 0.3, "max_len": 26,
       "sample_tokens": 24, "drain_s": 5.0}
METRIC = '''"""A test reader: the number of traced ticks."""

LAYER = "serving/afd_engine"
UNIT = "ticks"
MOVES = "itl_p95_s"


def read(t):
    return float(t.ticks)
'''


SHARED = {"name": "tiny-shared", "engine": {"n_bo": 2, "mb_slots": 2,
                                           "prefill_chunk": 8},
          "port": dict(CONFIGS["tiny-moe"]["port"], name="tiny-shared",
                       n_shared_experts=1, shared_d_ff=48)}
SHARED_CELL = "tiny-shared-cell"


def add_shared(root: Path) -> Path:
    """A MoE with a shared expert added to ``root`` as a cell by writing
    new files (and its entries in ``BENCHMARK.json``)."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    (root / "afdbench" / "configs" / "tiny-shared.json").write_text(
        json.dumps(SHARED))
    (root / "afdbench" / "checks" / f"{SHARED_CELL}.json").write_text(
        json.dumps({"mean_gap": {"limit": LIMIT}, "min_tokens": 12}))
    bench["configs"].append({"name": "tiny-shared", "source": "test",
                             "file": "afdbench/configs/tiny-shared.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": SHARED_CELL, "config": "tiny-shared",
                               "traffic": "tiny", "chips": 1, "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def make_root(tmp: Path) -> Path:
    """The benchmark's files under ``tmp`` with the tiny cells, their
    traffic, checks and a test metric added by name, and the program."""
    (tmp / "src").symlink_to(ROOT / "src")
    shutil.copytree(ROOT / "afdbench", tmp / "afdbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for name, cfg in CONFIGS.items():
        (tmp / "afdbench" / "configs" / f"{name}.json").write_text(
            json.dumps(cfg))
        bench["configs"].append({"name": name, "source": "test",
                                 "file": f"afdbench/configs/{name}.json",
                                 "reduced": [], "why": "test"})
    (tmp / "afdbench" / "traffic" / "tiny.json").write_text(json.dumps(MIX))
    for cell, cfg in zip(CELLS, CONFIGS):
        (tmp / "afdbench" / "checks" / f"{cell}.json").write_text(json.dumps(
            {"mean_gap": {"limit": LIMIT}, "min_tokens": 12}))
        bench["workloads"].append({"name": cell, "config": cfg,
                                   "traffic": "tiny", "chips": 1,
                                   "why": "test"})
    (tmp / "afdbench" / "metrics" / "test.ticks.py").write_text(METRIC)
    bench["per_layer"].append({"name": "test.ticks", "unit": "ticks",
                               "better": "lower", "source": "program_span",
                               "layer": "serving/afd_engine",
                               "moves": "itl_p95_s",
                               "workloads": list(CELLS)})
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp
