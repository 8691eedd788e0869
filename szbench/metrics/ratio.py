"""ratio: input bytes over archive bytes, summed over every archive the
window's compress calls wrote."""


def read(r):
    calls = r.of("compress")
    size = sum(c.archive_bytes for c in calls)
    return sum(c.nbytes for c in calls) / size if size > 0 else None
