"""K2 launches (the program's `kernels.launches`) over the window per document stored."""


def read(run):
    docs = run.counts.get("docs_stored")
    k2 = sum(v for k, v in run.launches.items() if k.startswith("ntt"))
    return k2 / docs if docs else None
