"""The ONE home of the process-exit taxonomy.

Every deliberate nonzero exit in the resilience stack used to be a
magic number duplicated across modules and the tests that assert on
them — incident self-termination hard-coded 43 in responder.py and
again in test_health, the replay CLI's divergence exit 2 restated in
test_replay, the selftest gates' exit-1 contract restated per gate.
A supervisor (``resilience.remediation.supervisor``) now BRANCHES on
these codes — restart vs. stop vs. escalate — so the taxonomy must be
one importable enum, not a folklore of literals:

- ``OK`` (0)                    — clean completion.
- ``FAILURE`` (1)               — the generic "something failed" status:
  a failed selftest/gate check, a replay hard error (missing anchor,
  corpus mismatch), an uncaught traceback. A supervisor does NOT
  restart on it: the failure is not one the resilience machinery
  recovers from by re-running.
- ``USAGE`` (2)                 — argparse's bad-arguments exit. The
  replay CLI deliberately shares the number for DIVERGENCE (below):
  both mean "the invocation's premise did not hold", and the replay
  verify mode predates this enum — the alias keeps its wire contract.
- ``REPLAY_DIVERGENCE`` (2)     — ``python -m apex_tpu_torch.resilience.replay``
  verify/--diff: the re-execution completed and DISAGREED with the
  journal (a verification failure, distinct from ``FAILURE``'s
  could-not-verify).
- ``INCIDENT`` (43)             — the incident responder's coordinated
  self-termination (resilience.health): spans flushed, pending save
  tombstoned, restart-me semantics. Distinct from success (0), python
  tracebacks (1), argparse (2), and signal deaths (128+N) so a
  supervisor can tell "ended by incident response" from every other
  ending.
- ``REMEDIATION_RESTART`` (44)  — the auto-remediation controller
  requests a restart under a CHANGED plan (quarantined topology, a
  probation readmit, a post-preemption rejoin): the supervisor reads
  the persisted remediation state and relaunches accordingly
  (resilience.remediation; docs/resilience.md "Auto-remediation").
- ``REMEDIATION_HALT`` (45)     — the controller escalated to halt:
  bounded retries exhausted or no admissible topology left. The
  supervisor stops and surfaces the case record; restarting would burn
  goodput on a fault the machinery already proved it cannot heal.

Copied from apex_tpu/resilience/exit_codes.py, which imports no JAX.
"""

import enum

__all__ = ["ExitCode", "RESTARTABLE_EXIT_CODES"]


class ExitCode(enum.IntEnum):
    """The process-exit taxonomy (module docstring)."""

    OK = 0
    FAILURE = 1
    USAGE = 2
    REPLAY_DIVERGENCE = 2
    INCIDENT = 43
    REMEDIATION_RESTART = 44
    REMEDIATION_HALT = 45


#: the codes a supervisor answers by RELAUNCHING: the incident
#: responder's self-termination (resume from the last verified step)
#: and the remediation controller's plan-change restarts. Everything
#: else either succeeded or failed in a way a re-run does not fix.
RESTARTABLE_EXIT_CODES = frozenset({
    ExitCode.INCIDENT, ExitCode.REMEDIATION_RESTART,
})
