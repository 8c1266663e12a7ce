"""Serving CLI — the port's counterpart of the reference
``repro/launch/serve.py``: replays a seeded traffic scenario through the
continuous-batching engine on one card and prints the SLO report.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b \
      [--smoke] [--scenario steady] [--requests 8] [--seed 0] [--slots 4] \
      [--device cuda] [--json PATH]

``--arch`` is any registered token LM: of the hybrid, SSM, dense or MoE
family (``zamba2-1.2b``, ``mamba2-2.7b``, ``qwen3-14b``, ``qwen2.5-14b``,
``granite-3-2b``, ``qwen2-moe-a2.7b``, ``granite-moe-1b-a400m``;
``qwen1.5-110b`` only with ``--smoke``, its full width does not fit one
card).  The encoder-decoder and VLM archs are refused, as the reference's
runner refuses them: they run through ``get_model(cfg).prefill`` and
``decode_step``.  The full-width model is drawn at random in bf16 (no
weights are needed); on the card every prefill runs its attention through
the flash kernel (K6, grouped-query heads in the kernel) and, for the
hybrid and the Mamba2 LM, its SSD intra-chunk terms through the SSD kernel
(K7).  The engine consults the Lemma-1 ``ServeAutoscaler`` over the
runner's logical ring (``serve.elastic``), as the reference's CLI does: a
scheduled device loss replans the ring on the survivors and rescales the
slots, and in-flight requests restart from their prompts.  The ring is
one device, as ``jax.devices()`` is for the reference on a one-card host;
``serve(..., n_devices=8)`` starts it wider.  Without a GPU it exits with
an error unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import Sequence

import torch

from repro_torch.configs import ModelConfig, get_config, smoke_config
from repro_torch.serve import (
    SCENARIO_NAMES,
    EngineResult,
    Scenario,
    ServeAutoscaler,
    ServingEngine,
    TorchModelRunner,
    make_traffic,
    scenario_preset,
    snap_prompt_buckets,
)

__all__ = ["ServeResult", "serve", "report_lines", "main"]


@dataclasses.dataclass
class ServeResult(EngineResult):
    """The engine's result with the config and the scenario (prompt buckets
    snapped to the SSM chunk) that produced it, and the runner's device
    count at the end."""
    cfg: ModelConfig
    scenario: Scenario
    n_devices: int


def serve(arch: str, *, smoke: bool = False, scenario: str = "steady",
          seed: int = 0, slots: int = 4,
          device: str | torch.device | None = None, clock=None,
          n_devices: int = 1, **scenario_overrides) -> ServeResult:
    """Serve ``scenario``'s seeded traffic with ``arch`` (random weights
    from seed 0, as the reference's runner) on ``device`` (default the
    card), the runner a logical ring of ``n_devices`` under the Lemma-1
    autoscaler; ``scenario_overrides`` replace preset fields
    (``n_requests``, ``prompt_buckets``, ...)."""
    cfg = smoke_config(arch) if smoke else get_config(arch)
    sc = scenario_preset(scenario, **scenario_overrides)
    sc = sc.replace(prompt_buckets=snap_prompt_buckets(cfg, sc.prompt_buckets))
    trace = make_traffic(sc, seed)
    runner = TorchModelRunner(cfg, n_slots=slots, max_len=sc.max_len,
                              device=device, n_devices=n_devices)
    runner.warmup(sc.prompt_buckets)
    autoscaler = ServeAutoscaler(runner.n_devices, slots)
    engine = ServingEngine(runner, n_slots=slots, clock=clock,
                           autoscaler=autoscaler)
    result = engine.run(trace, sc)
    return ServeResult(**{f.name: getattr(result, f.name)
                          for f in dataclasses.fields(result)},
                       cfg=cfg, scenario=sc, n_devices=runner.n_devices)


def report_lines(result: ServeResult, seed: int, slots: int) -> list[str]:
    """The reference CLI's report."""
    cfg, sc, slo = result.cfg, result.scenario, result.slo
    lines = [
        f"{cfg.name} · scenario={sc.name} seed={seed} slots={slots} "
        f"devices={result.n_devices}",
        f"  served {slo.n_finished}/{slo.n_submitted} requests "
        f"({result.n_prefills} prefills, {result.n_decode_steps} decode "
        f"steps, {slo.n_restarts} restarts, {len(result.replans)} "
        f"replans) in {slo.makespan_s:.3f}s",
        f"  TTFT p50/p99 {slo.p50_ttft_s * 1e3:.1f}/"
        f"{slo.p99_ttft_s * 1e3:.1f} ms · TPOT p50/p99 "
        f"{slo.p50_tpot_s * 1e3:.2f}/{slo.p99_tpot_s * 1e3:.2f} ms · "
        f"e2e p99 {slo.p99_e2e_s * 1e3:.1f} ms",
        f"  throughput {slo.throughput_tok_s:.1f} tok/s · goodput "
        f"{slo.goodput_tok_s:.1f} tok/s ({slo.n_slo_ok}/{slo.n_finished} "
        f"within TTFT<={sc.ttft_slo_s}s, TPOT<={sc.tpot_slo_s}s)",
    ]
    for rp in result.replans:
        lines.append(f"  replan[{rp.reason}] devices {rp.from_devices}->"
                     f"{rp.to_devices} slots {rp.from_slots}->{rp.to_slots} "
                     f"(Lemma-1 cores {rp.lemma1_cores}, epoch {rp.epoch_s})")
    for rid in sorted(result.streams)[:3]:
        lines.append(f"  req {rid}: {result.streams[rid][:8]}...")
    return lines


def main(argv: Sequence[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description="Serve a seeded traffic scenario on one card through "
                    "the continuous-batching engine and the Lemma-1 "
                    "autoscaler.")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--scenario", default="steady", choices=SCENARIO_NAMES)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=None,
                    help="override the preset's request count")
    ap.add_argument("--rate", type=float, default=None,
                    help="override the preset's arrival rate (req/s)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the kernels' plain versions)")
    ap.add_argument("--json", default=None, metavar="PATH")
    args = ap.parse_args(argv)

    overrides = {}
    if args.requests is not None:
        overrides["n_requests"] = args.requests
    if args.rate is not None:
        overrides["rate_rps"] = args.rate
    result = serve(args.arch, smoke=args.smoke, scenario=args.scenario,
                   seed=args.seed, slots=args.slots, device=args.device,
                   **overrides)
    for line in report_lines(result, args.seed, args.slots):
        print(line)
    if args.json:
        payload = {
            "arch": result.cfg.name,
            "scenario": dataclasses.asdict(result.scenario),
            "seed": args.seed,
            "slots": args.slots,
            "slo": result.slo.to_row(),
            "replans": [rp.to_dict() for rp in result.replans],
            "requests": [dataclasses.asdict(r)
                         for r in result.metrics.records.values()],
        }
        with open(args.json, "w") as f:
            json.dump(payload, f, indent=1)
        print(f"# json report -> {args.json}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
