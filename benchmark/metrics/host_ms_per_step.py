"""The host's ms to issue one step: the traced run's untraced steps, each
started on an idle card (synchronised first) and timed on the host's clock
until the step's call returns; the card runs behind it, so no launch waits
on a full queue unless one step alone fills it. On a mesh, each rank's,
averaged."""


def read(r):
    return r.host_ms_per_step
