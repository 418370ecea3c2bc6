"""idle_pct.stream: the share of the traced window in which no kernel,
copy or memset ran on the card (the mean over the cards used), in
percent."""
from orderbench import readers


def read(w):
    return readers.idle_pct(w)
