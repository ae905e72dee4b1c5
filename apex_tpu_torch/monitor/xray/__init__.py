"""Execution introspection (counterpart of apex_tpu/monitor/xray/): only
the serving KV pool's ``kind="memory"`` fields so far (``hbm.live``)."""
