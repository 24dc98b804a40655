"""Chaos campaign: deterministic fault schedules, end-to-end safety
invariants, and the campaign runner that judges them together.

- :mod:`.schedule` — seeded fault schedules over the named fault space
  (utils/failpoints.py sites), armable locally or over the wire on
  subprocess engine hosts (``chaos_arm``, flag-gated);
- :mod:`.invariants` — never-fail-open, zero-acked-write-loss,
  no-stale-verdict, split-journal-completion, retry-amplification;
- :mod:`.campaign` — drives the loadgen open-loop schedule against a
  full topology (2 shard groups × 2-peer failover × the planner stack)
  under fault schedules and SIGKILL/restart cycles, checking every
  invariant after each episode (``python -m
  spicedb_kubeapi_proxy_tpu_torch.chaos.campaign``). Its hosts are the
  port's engine host CLI, on ``--device`` (``cuda`` unless asked).

A copy of the JAX package's ``chaos/`` over the port's engine host,
planner and failpoint registry: the same schedules, digests and
invariants.
"""

from .invariants import (
    EpisodeEvidence,
    InvariantViolation,
    OpRecord,
    check_all,
    check_never_fail_open,
    check_no_stale_verdict,
    check_retry_amplification,
    check_split_journal_complete,
    check_zero_acked_write_loss,
    retry_amplification_bound,
)
from .schedule import (
    ChaosScheduleError,
    FaultSchedule,
    FaultSpec,
    brownout_schedule,
    parse_action,
)

__all__ = [
    "ChaosScheduleError", "EpisodeEvidence", "FaultSchedule",
    "FaultSpec", "InvariantViolation", "OpRecord", "brownout_schedule",
    "check_all", "check_never_fail_open", "check_no_stale_verdict",
    "check_retry_amplification", "check_split_journal_complete",
    "check_zero_acked_write_loss", "parse_action",
    "retry_amplification_bound",
]
