"""nd_host_s.order: per ordering, self seconds of the program's
``nd:*``, ``coarsen:*``, ``band:*`` and ``dnd:*`` spans but
``nd:initial``: the recursion's own host steps (ELL tiles, components,
induced subgraphs, checks, projections, coarse graphs, leaf orderings,
the distributed splits, gathers and band fragments, the assembly), each
span less the spans inside it (the rebuilds' ``stage:rebuild`` among
them, which ``dist_s.order`` reads).  None where the program opens none
of them."""
from orderbench import readers

PREFIXES = ("nd:", "coarsen:", "band:", "dnd:")


def read(w):
    self_s = getattr(w.ins, "span_self_s", None) or {}
    names = [n for n in self_s
             if n.startswith(PREFIXES) and n != "nd:initial"]
    if not names:
        return None
    return readers.per_ordering(w, sum(self_s[n] for n in names))
