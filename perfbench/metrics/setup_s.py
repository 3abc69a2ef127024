"""setup_s: seconds from the process's start to the window's opening
(host clock): loading, warming up and, in a checkout's first run, the
builds."""


def read(ctx):
    return ctx["setup_s"]
