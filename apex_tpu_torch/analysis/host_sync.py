"""Host-sync detector: host reads of device values inside the step
(counterpart of apex_tpu/analysis/host_sync.py).

A training step should touch the host once per log interval (the
MetricBag contract, monitor/metrics.py); anything else serializes the
device against Python. JAX's pass finds callbacks and host transfers in
the traced jaxpr. In eager torch a host sync is a read of a device
tensor's value on the host — ``bool(t)`` (every ``if t``), ``item``,
``tolist``, ``cpu()``, ``numpy()``, ``.to("cpu")``, ``float(t)``,
``int(t)`` — and the recorder (``passes.Recorder``) finds each on
either device, as reads of values on the step's device, with the ops
that size their output from the data and, on the card, the blocking
copies of a host tensor to it:

- ``host-sync.transfer`` — a host wait on the device inside the step
  (JAX's ``host-sync.transfer``: a ``device_put`` to host memory), one
  finding a (method, site).
- ``host-sync.unrecorded`` — on the card only: a synchronizing call
  that ``torch.cuda.set_sync_debug_mode("warn")`` reported at a site
  where the recorder saw no read (a sync the recorder cannot see, such
  as ``nonzero`` or a boolean-mask index), so the two lists must agree
  site by site.

The port's one known sync is the anomaly gate (``if not bool(gate)``,
resilience/replay/targets.py), allowlisted with its reason.
"""

from typing import Iterable

from apex_tpu_torch.analysis.findings import Finding, SEV_ERROR
from apex_tpu_torch.analysis.passes import trace_pass

__all__ = ["host_sync_pass"]


@trace_pass("host-sync")
def host_sync_pass(ctx) -> Iterable[Finding]:
    rec = ctx.recording
    for (method, site), count in sorted(rec.reads.items()):
        yield ctx.finding(
            "host-sync.transfer",
            f"{method} waits on the device inside the step: one host "
            f"round trip per call (the bag/router path exists so this "
            f"crossing is paid once per interval)",
            site=site, severity=SEV_ERROR, count=count,
            data={"method": method},
        )
    if rec.syncs is None:
        return
    read_sites = {site for _, site in rec.reads}
    for (node, site), count in sorted(rec.syncs.items()):
        if site not in read_sites:
            yield ctx.finding(
                "host-sync.unrecorded",
                "set_sync_debug_mode reports a synchronizing call here that "
                "the recorder saw no host wait at"
                + (f" (in the backward's {node})" if node else ""),
                site=site, severity=SEV_ERROR, count=count,
                data={"node": node},
            )
