"""The few settings of a Quinoa control file (.q) that the reference needs,
read by its own small tokenizer: the CFL number, the materials' ratios of
specific heats, the boundary side sets and the number of materials."""

from __future__ import annotations


def _tokens(text):
    out = []
    for line in text.splitlines():
        line = line.split("#", 1)[0]
        out += line.replace('"', " ").split()
    return out


def _list_after(tok, key, cast):
    """The values after the first `key ... end` (the `sideset` or
    `gamma` list) as a list, or [] when key is absent."""
    if key not in tok:
        return []
    i = tok.index(key) + 1
    if tok[i] == "sideset":
        i += 1
    vals = []
    while tok[i] != "end":
        vals.append(cast(tok[i]))
        i += 1
    return vals


def parse(text):
    tok = _tokens(text)
    return dict(
        scheme=tok[tok.index("scheme") + 1],
        cfl=float(tok[tok.index("cfl") + 1]),
        gamma=_list_after(tok, "gamma", float),
        nmat=int(tok[tok.index("nmat") + 1]) if "nmat" in tok else 1,
        bc_sym=_list_after(tok, "bc_sym", int),
        bc_extrapolate=_list_after(tok, "bc_extrapolate", int),
        limiter=tok[tok.index("limiter") + 1] if "limiter" in tok else None,
        flux=tok[tok.index("flux") + 1] if "flux" in tok else None,
    )
