"""launch_calls_per_step.<cell>: the runtime's kernel-launch and
graph-launch calls (``trace.LAUNCH_CALLS``) in the traced slice, per
training step."""

UNIT = "calls/step"
SOURCE = "device_trace"


def read(ctx):
    s = ctx["summary"]
    if s is None or s["busy_s"] <= 0 or not s["work"].get("steps"):
        return None
    return sum(s["launch_calls"].values()) / s["work"]["steps"]
