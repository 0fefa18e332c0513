"""MDR over subdomains spread across cards (the counterpart of
``mgard_tpu.parallel.mdr_sharded``): not ported yet."""


def _unported(*_args, **_kwargs):
    raise NotImplementedError(
        "sharded MDR is not ported yet (ROADMAP queue 1 item 14); "
        "mgard_tpu_torch.mdr.MDRefactorDecomposed runs the subdomains on one "
        "device")


MDRefactorSharded = MDReconstructSharded = _unported
write_mdr_sharded = read_mdr_sharded = _unported
