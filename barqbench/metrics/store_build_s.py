"""Storage: seconds in ``QuadStore.build()`` (deduplicate and sort the four
index orders on the device) and ``GraphStats(store)`` (the planner's
statistics, a host pass over every quad), timed by the benchmark."""


def read(facts):
    return facts["store_build_s"]
