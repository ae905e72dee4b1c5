"""The restart half of self-healing: a supervisor that turns the
controller's exit codes into relaunches (counterpart of
apex_tpu/resilience/remediation/supervisor.py).

The in-job controller can decide — quarantine, readmit, halt — but it
cannot relaunch itself: the process that excluded a device is dead by
the time the reduced topology must start. ``supervise`` is that outer
loop, and it is deliberately tiny: everything it needs to know travels
through two channels the rest of the stack already maintains —

- the **exit code** (resilience/exit_codes.py): ``OK`` ends the job,
  ``REMEDIATION_RESTART``/``INCIDENT`` relaunch it,
  ``REMEDIATION_HALT`` and everything else stop it;
- the **persisted remediation state** (state.py): the topology to
  relaunch with (``excluded``), and — for an exit-43 incident kill,
  where the dying process's watchdog thread never reaches the
  controller — a supervisor-written ``pending`` note the next
  incarnation's controller adopts into a case.

Incarnations are BOUNDED (``max_incarnations``): a supervisor that
restarts forever converts one unhealable fault into infinite badput,
which is exactly the failure shape the controller's escalate-to-halt
exists to prevent — the bound here is the backstop for a job whose
controller never gets far enough to escalate.

``command_for(device_count) -> argv`` and
``env_for(device_count) -> env`` parameterize the relaunch. Where the
JAX package pins the virtual CPU topology into ``XLA_FLAGS``, a port
incarnation is a ``torch.distributed`` world: :func:`torchrun_command`
launches a training command as ``python -m
apex_tpu_torch.resilience.remediation.launch --standalone
--nproc-per-node N`` (``torch.distributed.run`` that exits with the
failed rank's own code), one rank a device, and the default
``env_for`` passes this process's environment on with
``APEX_TORCH_DEVICES=N``. A real fleet launcher substitutes its own
scheduler call; the loop, the state file, and the exit-code contract
are unchanged.

Host-only by design: the supervisor runs on whatever box babysits the
job.
"""

import dataclasses
import logging
import os
import subprocess
import sys
import time
from typing import Callable, List, Optional

from apex_tpu_torch.resilience.exit_codes import (
    RESTARTABLE_EXIT_CODES,
    ExitCode,
)
from apex_tpu_torch.resilience.remediation.state import RemediationState

logger = logging.getLogger("apex_tpu_torch.resilience.remediation")

__all__ = ["DEVICES_ENV", "Incarnation", "LAUNCHER", "SupervisorReport",
           "default_env_for", "supervise", "torchrun_command"]

#: the environment variable an incarnation finds its device count in
DEVICES_ENV = "APEX_TORCH_DEVICES"
#: the module an incarnation's world is launched through
LAUNCHER = "apex_tpu_torch.resilience.remediation.launch"


@dataclasses.dataclass
class Incarnation:
    """One launch's outcome."""

    index: int
    device_count: int
    exit_code: int
    duration_s: float


@dataclasses.dataclass
class SupervisorReport:
    """The whole supervised job's outcome."""

    incarnations: List[Incarnation]
    outcome: str          # "completed" | "halted" | "failed" | "exhausted"
    final_exit_code: int

    @property
    def ok(self) -> bool:
        return self.outcome == "completed"

    def summary(self) -> str:
        lines = [
            f"supervised job: {self.outcome} after "
            f"{len(self.incarnations)} incarnation(s) "
            f"(final exit {self.final_exit_code})"
        ]
        for inc in self.incarnations:
            lines.append(
                f"  incarnation {inc.index}: {inc.device_count} device(s), "
                f"exit {inc.exit_code}, {inc.duration_s:.1f}s"
            )
        return "\n".join(lines)


def default_env_for(device_count: int) -> dict:
    """This process's environment, with the incarnation's device count
    in :data:`DEVICES_ENV`."""
    env = dict(os.environ)
    env[DEVICES_ENV] = str(device_count)
    return env


def torchrun_command(command: List[str]) -> Callable[[int], List[str]]:
    """``command_for`` that launches ``command`` as a world of N ranks:
    ``python -m apex_tpu_torch.resilience.remediation.launch --standalone
    --nproc-per-node N`` (``torch.distributed.run`` keeping the failed
    rank's exit code) followed by ``command`` (a module's ``-m name`` or
    a script, and its arguments), a literal ``{devices}`` in any of them
    replaced by N."""
    def command_for(n: int) -> List[str]:
        return [sys.executable, "-m", LAUNCHER,
                "--standalone", f"--nproc-per-node={n}"] + [
                    c.replace("{devices}", str(n)) for c in command]

    return command_for


def supervise(
    command_for: Callable[[int], List[str]],
    save_dir: str,
    world_devices: int,
    max_incarnations: int = 8,
    env_for: Callable[[int], dict] = default_env_for,
    runner: Optional[Callable[[List[str], dict], int]] = None,
    timeout_s: Optional[float] = None,
) -> SupervisorReport:
    """Run a job to completion under remediation restarts (module
    docstring).

    ``runner(argv, env) -> exit_code`` is injectable for tests; the
    default runs ``subprocess.run``. The job's stdout/stderr pass
    through — the supervisor supervises, it does not buffer.
    """

    def _default_runner(argv: List[str], env: dict) -> int:
        try:
            return subprocess.run(argv, env=env, timeout=timeout_s).returncode
        except subprocess.TimeoutExpired:
            # run() already killed the wedged child; a supervisor-killed
            # hang is the incident shape (restart me, resume from the
            # last verified step) — the adoption note records it
            logger.error(
                "supervisor: incarnation exceeded timeout_s=%s — killed; "
                "treating as an incident exit", timeout_s,
            )
            return int(ExitCode.INCIDENT)

    run = runner if runner is not None else _default_runner
    incarnations: List[Incarnation] = []
    for index in range(max_incarnations):
        state = RemediationState.load(save_dir)
        device_count = state.device_count(world_devices)
        argv = command_for(device_count)
        logger.warning(
            "supervisor: incarnation %d on %d device(s)%s: %s",
            index, device_count,
            f" (excluded {state.excluded})" if state.excluded else "",
            " ".join(map(str, argv)),
        )
        t0 = time.perf_counter()
        rc = int(run(argv, env_for(device_count)))
        incarnations.append(Incarnation(
            index=index, device_count=device_count, exit_code=rc,
            duration_s=time.perf_counter() - t0,
        ))
        if rc == int(ExitCode.OK):
            return SupervisorReport(incarnations, "completed", rc)
        if rc == int(ExitCode.REMEDIATION_HALT):
            logger.error(
                "supervisor: controller escalated to halt (exit %d); "
                "not restarting — see the terminal kind=\"remediation\" "
                "record for the case", rc,
            )
            return SupervisorReport(incarnations, "halted", rc)
        if rc not in RESTARTABLE_EXIT_CODES:
            logger.error(
                "supervisor: incarnation %d failed with exit %d — not a "
                "restartable code (see resilience/exit_codes.py); "
                "stopping", index, rc,
            )
            return SupervisorReport(incarnations, "failed", rc)
        if rc == int(ExitCode.INCIDENT):
            # the incident responder killed the job from its watchdog
            # thread; the dying controller persisted nothing — write the
            # adoption note so the next incarnation opens the case
            state = RemediationState.load(save_dir)
            state.pending = {
                "kind": "incident", "exit_code": rc,
                "incarnation": index,
            }
            state.save()
        logger.warning(
            "supervisor: incarnation %d exited %d — relaunching", index, rc,
        )
    logger.error(
        "supervisor: incarnation budget exhausted (%d); stopping",
        max_incarnations,
    )
    return SupervisorReport(
        incarnations, "exhausted",
        incarnations[-1].exit_code if incarnations else int(ExitCode.FAILURE),
    )


def _main(argv=None) -> int:
    """``python -m apex_tpu_torch.resilience.remediation --supervise`` shim
    (argument plumbing lives in __main__.py; this keeps subprocess-free
    unit tests possible)."""
    import argparse

    parser = argparse.ArgumentParser(
        prog="apex_tpu_torch.resilience.remediation.supervisor",
        description="run a command under remediation restarts",
    )
    parser.add_argument("--save", required=True,
                        help="the job's checkpoint dir (remediation state "
                             "+ checkpoints live here)")
    parser.add_argument("--devices", type=int, required=True,
                        help="the full (un-quarantined) device count")
    parser.add_argument("--max-incarnations", type=int, default=8)
    parser.add_argument("--launcher", default="torchrun",
                        choices=["torchrun", "none"],
                        help="torchrun: launch the command as a world of "
                             "N ranks (torch.distributed.run, keeping the "
                             "failed rank's exit code); none: run it as "
                             "it is")
    parser.add_argument("command", nargs=argparse.REMAINDER,
                        help="the training command; a literal {devices} "
                             "in any argument is substituted with the "
                             "incarnation's device count")
    args = parser.parse_args(argv)
    command = [c for c in args.command if c != "--"]
    if not command:
        parser.error("a training command is required after --")
    command_for = command_for_launcher(command, args.launcher)

    report = supervise(
        command_for, args.save, args.devices,
        max_incarnations=args.max_incarnations,
    )
    print(report.summary(), flush=True)
    return report.final_exit_code


def command_for_launcher(command: List[str], launcher: str
                         ) -> Callable[[int], List[str]]:
    """``command_for`` of ``--launcher``: :func:`torchrun_command`, or
    the command as it is with ``{devices}`` substituted (``none``)."""
    if launcher == "torchrun":
        return torchrun_command(command)
    return lambda n: [c.replace("{devices}", str(n)) for c in command]


if __name__ == "__main__":
    sys.exit(_main())
