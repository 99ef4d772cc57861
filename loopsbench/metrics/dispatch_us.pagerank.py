"""dispatch_us.pagerank: the median host microseconds to enqueue one
PageRank iteration (the span ``solve.iter``: K1's call, K12's call, the
dangling term) over the window; the card runs behind the host."""
from loopsbench.readings import median_us


def read(run):
    return median_us(run, "solve.iter")
