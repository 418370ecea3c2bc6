"""opc: the mean factorisation operation count of the window's
permutations, by the benchmark's own symbolic factorisation after the
window."""


def read(w):
    return sum(w.opc) / len(w.opc) if w.opc else None
