"""setup_s: seconds from the harness's first line to the window's start:
imports, device start, kernel libraries (built only by a checkout's
first run), the fields, the containers of a reader cell and one warm
request (host clock)."""


def read(run):
    return run.setup_s
