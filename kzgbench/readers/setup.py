"""Seconds of set-up: loading the setup onto the device, building what the
program builds, and the warm-up calls, which capture every graph the
traffic's shapes need (and, on the comb path, build the table)."""


def read(ctx):
    return ctx.setup_s
