"""Multi-device paths of the port (the counterpart of ``mgard_tpu.parallel``):
not ported yet."""
