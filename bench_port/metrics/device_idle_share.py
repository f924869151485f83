"""device_idle_share: the share of the window in which no kernel ran: one
less the union of each rank's kernel intervals inside the window, summed
over the ranks of a card (processes take turns on it) and averaged over
the cards, over the window."""
from bp.stats import traces


def read(run):
    tr = traces(run)
    if not tr:
        return None
    return 100.0 * (1.0 - run["busy_s"] / run["seconds"])
