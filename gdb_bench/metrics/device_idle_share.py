"""Share of the window in which no operation ran on the card, in %:
1 - (union of the profiler's device intervals) / window."""


def read(view):
    return view.idle_share()
