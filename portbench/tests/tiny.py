"""Tiny runs of the benchmark's cells on the CPU for its tests: the cell's
configuration with its widths cut (the plain twins run the kernels' work),
its mix scaled down, and the harness driven without the CLI's look for a
card."""

from __future__ import annotations

import copy
import time

from portbench import bench

TINY_MODEL = {"model.image_encoder": "vit_test", "model.bert_layers": 2, "model.bert_hidden": 128,
              "model.bert_heads": 2, "model.hidden_dim": 128, "model.num_heads": 2, "model.btia_layers": 1,
              "model.answer_vocab_size": 64}


def tiny_run(cell_name: str, seed: int = 2**31 + 17, seconds: float = 2.0, fault=None, variant=None,
             trace: bool = False, reg: bench.Registry = None) -> bench.Run:
    import torch

    # test processes share the host's cores: more threads a process only
    # make them wait for each other
    torch.set_num_threads(min(2, torch.get_num_threads()))
    reg = reg or bench.Registry()
    cell = reg.cell(cell_name)
    mix = copy.deepcopy(reg.mix(cell["traffic"]))
    overrides = dict(TINY_MODEL)
    if mix["kind"] == "serve":
        overrides["model.num_answer_queries"] = 8
        mix["images"]["size"] = 256  # the tiny model's ingest size
        mix["warmup_requests"] = 4
        mix["server"].update(image_batch=2, questions_per_image=8)
        if mix["loop"] == "closed":
            mix["questions"]["per_request"]["n"] = 8
        else:
            mix["server"]["pair_budget"] = 16
            mix["questions"]["per_request"]["max"] = 8
            mix["rate_rps"] = 4.0
    else:
        overrides.update({"model.num_answer_queries": 0, "train.batch_size": 4, "train.steps_per_call": 2})
        mix["corpus"].update(train_images=24, test_images=4, answers=40)
    limits = dict(reg.limits(cell_name), sample_requests=4)
    run = bench.Run(cell=cell, cfg_file=reg.config(cell["config"]), mix=mix, limits=limits, seed=seed,
                    seconds=seconds, trace=trace, device="cpu", overrides=overrides, fault=fault,
                    variant=variant, t_start=time.perf_counter())
    return bench.drive(run)
