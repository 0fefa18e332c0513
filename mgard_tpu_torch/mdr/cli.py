"""Command line of MDR (the counterpart of ``mgard_tpu.mdr.cli``, flag
compatible with the reference's ``mdr-x``): not ported yet. Its reader and
writer of reference MDR-X directories are ``formats/mdrx_stream.py``."""


def main(argv=None):
    raise NotImplementedError(
        "the MDR command line is not ported yet (ROADMAP queue 1 item 13)")


if __name__ == "__main__":
    main()
