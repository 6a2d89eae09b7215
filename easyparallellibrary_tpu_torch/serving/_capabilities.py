"""Unified serving capability guards.

One site answers "can this config serve?" so the engine, the drafters
and any future serving component reject an unsupported composition with
the SAME actionable message — each pointing at the ROADMAP open item
that will lift the limit, instead of three slightly different inline
raises that drift apart (the PR-3 engine carried two of these inline;
speculative decoding would have added a third family).

Everything here is a pure check: no imports of the engine, no device
work, safe to call before any allocation.
"""

from __future__ import annotations

ROADMAP_PP_SERVING = (
    "pipeline-parallel serving is a ROADMAP open item ('Pipeline-parallel "
    "serving'; docs/serving.md 'Current limits')")
ROADMAP_MOE_SERVING = (
    "MoE serving (expert-parallel decode) is a ROADMAP open item "
    "('MoE serving'; docs/serving.md 'Current limits')")
ROADMAP_DRAFT_DISTILL = (
    "training a matched drafter is a ROADMAP follow-up ('draft-model "
    "distillation'; docs/serving.md 'Speculative decoding')")
ROADMAP_PREEMPTION = (
    "priority reorders ADMISSION, and on the paged engine "
    "(serving.paged.enabled) a RUNNING throughput-class slot is "
    "preempted (reason 'preempted') both on block-pool exhaustion and "
    "EAGERLY when a latency-class arrival would otherwise queue "
    "(serving/proactive_preemptions; docs/robustness.md)")

# Finish-reason glossary (docs/robustness.md "Serving resilience"):
#   length      — max_new_tokens reached
#   stop_token  — the request's stop token was generated
#   deadline    — Request.deadline_s / ttft_budget_s expired
#   cancelled   — client cancellation (scheduler/engine .cancel(uid))
#   shed        — rejected at submit by admission control (overload)
#   failed      — quarantined more than serving.resilience.max_requeues
#                 times (persistent bad steps implicating this request)
#   preempted   — paged out mid-flight because the KV block pool ran dry
#                 (paged engine; rides the requeue prefix-replay path, so
#                 unlike the others it names a REQUEUE, not a final
#                 resolution — the request finishes later under one of
#                 the reasons above with its output bit-intact)
FINISH_REASONS = ("length", "stop_token", "deadline", "cancelled",
                  "shed", "failed", "preempted")

# Admission classes: "latency" jumps the FCFS queue, "throughput" rides
# it.  (True preemption of running requests: ROADMAP_PREEMPTION.)
PRIORITIES = ("latency", "throughput")


def check_request_fields(req) -> None:
  """Validate a Request's lifecycle-control fields at submit time, so a
  typo'd priority class or negative deadline fails loudly instead of
  silently never expiring."""
  if req.priority not in PRIORITIES:
    raise ValueError(
        f"request priority must be one of {PRIORITIES}; got "
        f"{req.priority!r} — {ROADMAP_PREEMPTION}")
  if req.deadline_s < 0:
    raise ValueError(f"deadline_s must be >= 0 (0 = none): "
                     f"{req.deadline_s}")
  if req.ttft_budget_s < 0:
    raise ValueError(f"ttft_budget_s must be >= 0 (0 = none): "
                     f"{req.ttft_budget_s}")
  if (req.deadline_s > 0 and req.ttft_budget_s > 0
      and req.ttft_budget_s > req.deadline_s):
    raise ValueError(
        f"ttft_budget_s {req.ttft_budget_s} exceeds deadline_s "
        f"{req.deadline_s}: the first token can never beat a budget "
        f"that outlives the whole request")


def check_servable(cfg, role: str = "the serving engine") -> None:
  """Reject model configs the serving stack cannot run.

  ``cfg`` is a :class:`models.gpt.GPTConfig` (or anything exposing
  ``pipeline_stages`` / ``num_experts``); ``role`` names the component
  doing the rejecting so a draft-model failure reads differently from a
  target-model one.
  """
  if cfg.pipeline_stages > 1:
    raise ValueError(
        f"{role} is single-program (pipeline_stages=1) but got "
        f"pipeline_stages={cfg.pipeline_stages}; restore the checkpoint "
        f"into a non-pipelined config (runtime.saver.restore_params) — "
        f"{ROADMAP_PP_SERVING}")
  if cfg.num_experts > 0:
    raise ValueError(
        f"{role} does not support MoE checkpoints yet "
        f"(num_experts={cfg.num_experts}); restore a dense checkpoint — "
        f"{ROADMAP_MOE_SERVING}")


def check_draft_compatible(target_cfg, draft_cfg) -> None:
  """Reject draft models whose shapes cannot verify against the target.

  The verify step compares token ids, so the two models must share one
  vocabulary; the draft slot cache must cover every committed position a
  request can reach, so the draft ``max_seq_len`` must be at least the
  target's.  Everything else (depth, width, heads) is free to differ —
  that asymmetry is the whole point of a drafter.
  """
  check_servable(draft_cfg, role="a draft model")
  if draft_cfg.vocab_size != target_cfg.vocab_size:
    raise ValueError(
        f"draft model vocab_size {draft_cfg.vocab_size} != target "
        f"vocab_size {target_cfg.vocab_size}: speculative verification "
        f"compares token ids under one vocabulary; use a drafter trained "
        f"on the target tokenizer — {ROADMAP_DRAFT_DISTILL}")
  if draft_cfg.max_seq_len < target_cfg.max_seq_len:
    raise ValueError(
        f"draft model max_seq_len {draft_cfg.max_seq_len} < target "
        f"max_seq_len {target_cfg.max_seq_len}: the draft slot cache "
        f"must cover every position a request can commit (requests are "
        f"admitted against the target's max_seq_len); pad the draft "
        f"config's max_seq_len up to the target's")


def check_draft_fits_chunk(k: int, chunk: int) -> None:
  """The fused step carries each decode slot's last committed token plus
  its ``k`` drafts in one ``chunk``-wide block; reject a drafter the
  step could never schedule."""
  if k < 1:
    raise ValueError(f"speculative draft length k must be >= 1; got {k}")
  if k + 1 > chunk:
    raise ValueError(
        f"speculative draft length k={k} needs prefill_chunk >= k + 1 "
        f"(one chunk holds the last committed token plus the drafts); "
        f"got prefill_chunk {chunk} — raise serving.prefill_chunk or "
        f"lower serving.speculative.k")
