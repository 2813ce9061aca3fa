"""Set-up: seconds from the process's start to the end of warm-up (imports,
the kernel library's load or build, the data's generation and load, the
store's build, the statistics, the warm-up rounds), on the host's clock."""


def read(facts):
    return facts["setup_s"]
