"""setup_s: process start to the window's first call: generation, the
program's conversion, plan and upload, and the warm-up."""


def read(rec):
    return rec.setup_s
