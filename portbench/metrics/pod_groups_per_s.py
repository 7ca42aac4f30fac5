"""pod_groups_per_s (end to end, host clock): the pod × group pairs of
every request answered in the window, over the window's seconds (first
send to last answer). The north star's decisions a second, at the cell's
size."""


def read(ctx):
    window = ctx["window"]
    if not window.done or window.seconds <= 0:
        return None
    return sum(ctx["pool"][w].pod_groups for w in window.done) / window.seconds
