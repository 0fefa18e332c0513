"""Command line of MDR (the counterpart of ``mgard_tpu.mdr.cli``, flag
compatible with the reference's ``mdr-x``): not ported yet."""


def main(argv=None):
    raise NotImplementedError(
        "the MDR command line is not ported yet (ROADMAP queue 1 item 13; "
        "its MDR-X stream reader is item 12)")


if __name__ == "__main__":
    main()
