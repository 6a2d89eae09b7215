# Build / test entry points (reference analog: /root/reference/Makefile).

all: build

build:
	$(MAKE) -C csrc

test: build
	python -m pytest tests/ -x -q

# epl-lint: static invariant checker (compile-once, host-sync,
# donation, metric schema, span pairing, lock discipline) over the
# package — exits non-zero on any non-baselined finding
# (docs/static_analysis.md; the quick-marked tests/test_analysis.py
# zero-findings test enforces the same gate in tier-1).
lint:
	python -m easyparallellibrary_tpu.analysis

# Perf regression gate: device cost-card invariants (compile count,
# flops/token, KV bytes/request, peak-HBM bound, donation-verified —
# collected live from the canonical tiny twins) and selected
# BENCH_EVIDENCE.json structural metrics, pinned with tolerances in
# perf_budget.json (observability/perfgate.py; docs/observability.md
# "Device truth").  Malformed evidence records are REFUSED, not
# skipped.  Regenerate the budget only for an intentional perf change:
# python -m easyparallellibrary_tpu.observability.perfgate --write-budget
perf-gate:
	python -m easyparallellibrary_tpu.observability.perfgate

# The full static + perf gate chain: epl-lint, then the perf budget.
gate: lint perf-gate

# The PyTorch port's twins of the three targets above: epl-lint over
# easyparallellibrary_tpu_torch/, and the port's perf budget
# (easyparallellibrary_tpu_torch/perf_budget.json) checked with the
# reference twins on the CPU (drop --device cpu on a machine with the GPU).
lint-torch:
	python -m easyparallellibrary_tpu_torch.analysis

perf-gate-torch:
	python -m easyparallellibrary_tpu_torch.observability.perfgate --device cpu

gate-torch: lint-torch perf-gate-torch

bench:
	python bench.py

# Fault-injection suite standalone (testing/chaos.py + docs/robustness.md).
chaos:
	python -m pytest tests/test_resilience.py -q

# Serving chaos: NaN steps, hung steps, flaky drafters, Poisson overload
# against the resilient engine (docs/robustness.md "Serving resilience").
chaos-serve:
	python -m pytest tests/test_serving_resilience.py -q

# Router chaos: replica kills mid-decode, replica hangs, flapping health
# against the multi-replica control plane — bit-exact failover, graceful
# drain/rejoin, circuit breaker (docs/serving.md "Multi-replica serving")
# — ACROSS BOTH TRANSPORTS: the in-process simulations
# (test_serving_router.py) and the process-isolated real fault domain
# (test_serving_transport.py: SIGKILL/SIGSTOP/lost replies) — plus the
# fleet observability acceptance (one connected flow per migrated
# request, SLO breach window logged, diagnostic bundle captured;
# docs/observability.md "Reading a failover trace").
chaos-router:
	python -m pytest tests/test_serving_router.py tests/test_serving_transport.py tests/test_observability_fleet.py -q

# Process-transport chaos standalone: subprocess replicas behind the
# wire (serving/transport.py) — real os.kill(pid, SIGKILL) mid-decode
# with journal recovery, SIGSTOP stalls tripping wire deadlines into
# condemn+fence, dropped-reply exactly-once (uid dedup + watermark
# resync), breaker-probe child respawn, and orphan reaping
# (docs/robustness.md "Process-isolated replicas").
chaos-proc:
	python -m pytest tests/test_serving_transport.py -q

# Self-healing chaos: an injected 3x overload burst on a 2-replica
# process-transport fleet — the autoscaler spawns a third replica (a
# REAL subprocess), the autotuner tightens budgets, SLO burn recovers
# with no operator input, every non-shed request bit-exact vs the
# fault-free oracle, all replica compile counts stay 1, and after
# recovery the fleet drains back to 2 replicas; plus the quick-marked
# fault-free-equivalence pin (actuators enabled + no breaches ==
# baseline stream, zero actuations) (serving/autotune.py,
# serving/autoscale.py; docs/robustness.md "Self-healing fleet").
chaos-heal:
	python -m pytest tests/test_serving_autoscale.py -q

# Blue/green rollout chaos: begin a checkpoint rollout mid-traffic on a
# process-transport fleet, SIGKILL one blue replica child during the
# canary — its journaled requests fail over to the SURVIVING BLUE only
# (cross-version replay is refused; complete-in-place migration), zero
# requests lost, every response attributable to exactly one checkpoint
# version, the survivor's compile count stays 1, and the rollout still
# completes; plus the quick-marked contract pins (full rollout under
# live traffic, canary-breach rollback blue-bit-exact, fault-free
# guard) (serving/rollout.py; docs/robustness.md "Blue/green rollout").
chaos-rollout:
	python -m pytest tests/test_serving_rollout.py -q

# Front-door chaos: the streaming HTTP/SSE surface behind the reactor
# driver (serving/frontdoor/, serving/reactor.py) — reactor-vs-sweep
# bit-exactness pins, SSE byte-assembly vs direct submit(), real
# SIGKILL/SIGSTOP of process replicas behind live HTTP clients (zero
# lost, zero double-served), cancel-on-disconnect (slot + blocks freed,
# flow finalized), slow-reader shed isolation (docs/serving.md
# "Front door").
chaos-frontdoor:
	python -m pytest tests/test_serving_frontdoor.py -q

# Continuous batching vs static-batch generate() under Poisson arrivals
# (benchmarks/decode_throughput.py -> BENCH_EVIDENCE.json; docs/serving.md).
serve-bench:
	python benchmarks/decode_throughput.py

# Paged vs contiguous KV on a long-tail (64-4k mixed prompt) trace:
# useful tokens/s, steady-state decode step cost, concurrency at fixed
# HBM (benchmarks/decode_throughput.py --paged -> BENCH_EVIDENCE.json;
# docs/serving.md "Paged KV cache").
paged-bench:
	python benchmarks/decode_throughput.py --paged

# Warm vs cold TTFT with copy-on-write prefix caching: Zipf-shared
# templates under Poisson arrivals + a multi-turn chat trace
# (benchmarks/prefix_cache.py -> BENCH_EVIDENCE.json; docs/serving.md
# "Prefix caching").
prefix-bench:
	python benchmarks/prefix_cache.py

# Speculative vs plain decode on repetitive/incompressible traces
# (benchmarks/speculative_decode.py -> BENCH_EVIDENCE.json; docs/serving.md).
spec-bench:
	python benchmarks/speculative_decode.py

# Bounded admission queue + degradation ladder vs an unprotected engine
# under a Poisson overload burst (benchmarks/serving_overload.py ->
# BENCH_EVIDENCE.json; docs/robustness.md "Serving resilience").
overload-bench:
	python benchmarks/serving_overload.py

# Self-healing episode benchmark: the same seeded 3x overload burst
# served by a frozen 2-replica fleet vs one with the autotuner +
# autoscaler live (in-process replicas — the policy loop, not spawn
# cost, is what is measured; make chaos-heal covers the real spawn)
# (benchmarks/self_heal.py -> BENCH_EVIDENCE.json; docs/robustness.md
# "Self-healing fleet").
heal-bench:
	python benchmarks/self_heal.py

# Blue/green rollout episode benchmark: one seeded Poisson trace served
# by a never-rolled fleet, through a completed rollout, and through a
# canary-breach rollback (in-process replicas — admission/drain policy,
# not spawn cost, is what is measured; make chaos-rollout covers the
# real spawn/kill path) — zero lost requests, zero recompiles, routable
# capacity never below the pre-rollout floor, rollback restores blue
# bit-exactly (benchmarks/rollout.py -> BENCH_EVIDENCE.json;
# docs/robustness.md "Blue/green rollout").
rollout-bench:
	python benchmarks/rollout.py

# Replica-kill failover episode: 1 vs 2 replicas under a Poisson trace,
# then kill one mid-decode — zero lost requests, streams bit-exact vs
# the fault-free baseline — on BOTH transports: in-process replicas,
# then process-isolated replicas (real SIGKILL, journal recovery,
# N=1-vs-N=2 fleet tokens/s with the host-core-honest scaling number,
# zero orphans) (benchmarks/router_failover.py -> BENCH_EVIDENCE.json;
# docs/serving.md "Multi-replica serving" / "Replica transports").
router-bench:
	python benchmarks/router_failover.py
	python benchmarks/router_failover.py --transport process

# Front-door streaming latency: open-loop Poisson HTTP clients against
# the live SSE listener, reactor vs sweep — time-to-first-streamed-
# token p50/p99, inter-token-gap p99, tokens/s, zero lost + bit-exact
# across drivers (benchmarks/frontdoor_bench.py -> BENCH_EVIDENCE.json
# with hardware provenance; docs/serving.md "Front door").
frontdoor-bench:
	python benchmarks/frontdoor_bench.py

# Cost-card fleet simulator: golden replay-fidelity check (the sim
# must reproduce the recorded real-fleet chaos-heal actuation sequence
# exactly), then 100-replica diurnal + overload sweeps and a
# 1000-replica diurnal sweep with the full policy stack live —
# wall-seconds-per-simulated-hour recorded, speedup_x >= 100x at 100
# replicas pinned by make perf-gate (benchmarks/sim_fleet.py ->
# BENCH_EVIDENCE.json with provenance=sim; docs/simulator.md).
sim-bench:
	python benchmarks/sim_fleet.py

# Re-record the golden chaos-heal episode from a REAL 2-replica fleet
# (only when a policy change legitimately changes the actuation story;
# the golden-file diff then documents it — benchmarks/sim_golden.py ->
# tests/golden/sim_chaos_heal.json).
sim-golden:
	python benchmarks/sim_golden.py

# Tiny traced fit() + serving + router-failover episode on the CPU mesh
# -> trace_demo.json (schema-validated incl. request-flow events; load
# at ui.perfetto.dev; docs/observability.md).
trace-demo:
	python benchmarks/trace_demo.py

# Two-replica PROCESS-transport fleet, one SIGKILL mid-decode -> ONE
# merged multi-process trace (child rings harvested over the wire,
# clock-rebased, schema-validated: failed-over requests are single
# connected flows spanning parent + both child pids) + the latency
# report (benchmarks/trace_fleet.py; docs/observability.md
# "Distributed tracing").
trace-fleet:
	JAX_PLATFORMS=cpu python benchmarks/trace_fleet.py

# Re-measure the observability layer's serving overhead (tracer + SLO
# monitor + compile sentinel vs bare engine, interleaved per-step
# samples) and append the <=5% evidence to BENCH_EVIDENCE.json
# (benchmarks/obs_overhead.py; docs/observability.md).
obs-bench:
	python benchmarks/obs_overhead.py

help:
	@echo "Targets:"
	@echo "  build          - build the native IO extension (csrc/)"
	@echo "  test           - full pytest suite (stops on first failure)"
	@echo "  lint           - epl-lint static invariant checker (zero findings gate)"
	@echo "  perf-gate      - perf budget gate: cost cards + bench evidence (perf_budget.json)"
	@echo "  gate           - lint + perf-gate"
	@echo "  bench          - official perf capture (bench.py)"
	@echo "  chaos          - training fault-injection suite"
	@echo "  chaos-serve    - serving resilience chaos (NaN/hang/overload)"
	@echo "  chaos-router   - fleet chaos: replica kills, hangs, flapping health (both transports)"
	@echo "  chaos-proc     - process-transport chaos: SIGKILL/SIGSTOP/lost replies/orphans"
	@echo "  chaos-heal     - self-healing fleet: overload burst -> autotune + autoscale -> recover"
	@echo "  chaos-rollout  - blue/green rollout chaos: SIGKILL a blue mid-canary, zero lost"
	@echo "  chaos-frontdoor - HTTP/SSE front door chaos: disconnects, slow readers, kills behind the reactor"
	@echo "  heal-bench     - actuators-on vs frozen fleet under the overload burst"
	@echo "  rollout-bench  - blue/green rollout episode: 0 lost, 0 recompiles, blue bit-exact rollback"
	@echo "  serve-bench    - continuous batching vs static generate()"
	@echo "  paged-bench    - paged vs contiguous KV cache (long-tail trace)"
	@echo "  prefix-bench   - warm vs cold TTFT with prefix caching (Zipf + chat traces)"
	@echo "  spec-bench     - speculative vs plain decode"
	@echo "  overload-bench - admission control under Poisson overload"
	@echo "  router-bench   - replica-kill failover episode (0 lost requests)"
	@echo "  frontdoor-bench - SSE streaming latency: reactor vs sweep under Poisson HTTP load"
	@echo "  sim-bench      - fleet simulator: replay fidelity + 100/1000-replica sweeps"
	@echo "  sim-golden     - re-record the golden chaos-heal episode (real fleet)"
	@echo "  trace-demo     - emit + validate a demo trace (fit/serving/failover)"
	@echo "  trace-fleet    - merged multi-process trace: SIGKILL episode over the wire"
	@echo "  obs-bench      - tracer+SLO overhead evidence (<=5% budget)"
	@echo "  clean          - clean native build artifacts"
	@echo "Live watching: python -m easyparallellibrary_tpu.observability.report --follow <metrics.jsonl>"

clean:
	$(MAKE) -C csrc clean

.PHONY: all build test lint perf-gate gate lint-torch perf-gate-torch gate-torch bench chaos chaos-serve chaos-router chaos-proc chaos-heal chaos-rollout chaos-frontdoor serve-bench paged-bench prefix-bench spec-bench overload-bench router-bench frontdoor-bench heal-bench rollout-bench sim-bench sim-golden trace-demo trace-fleet obs-bench help clean
