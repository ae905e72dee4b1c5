"""Device-memory x-ray (counterpart of apex_tpu/monitor/xray/hbm/): only
``live.kv_pool_fields`` so far; the training watermark monitor is not
ported yet."""
