"""``setup.build_s``: seconds of the harness's span around the program's
build calls (mesh, space, operators, AMG hierarchy, upload of the initial
state), before any step."""


def read(run):
    return run.spans.get("build")
