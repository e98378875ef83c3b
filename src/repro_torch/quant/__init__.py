"""(1, e, m) formats and the int8 code layout."""
