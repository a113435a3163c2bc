"""Parser for the reference's `.q` control-file DSL.

The port's own copy of quinoa_tpu/control/qparser.py, unchanged: the tree
it returns is the contract both packages' configs are built from.

Counterpart of the reference's PEGTL grammars (src/Control/*/InputDeck/
Grammar.hpp, CommonGrammar.hpp): a block-structured keyword language

    title "..."
    inciter
      nstep 100
      scheme dg
      compflow
        material  gamma 1.4 end  end
        bc_sym  sideset 2 4 end  end
      end
    end

Blocks and list-valued keywords close with `end`; `#` starts a comment.

Parsing is context-sensitive the same way the reference grammar is: a
keyword opens a block only under the right parent (`beta` is an SDE block
under `walker` but a scalar coefficient under `compflow`).  The result is
a dict tree where every key maps to the LIST of its occurrences (repeated
blocks/keywords accumulate); use `first`/`only` to unwrap.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List

#: block keyword -> allowed parent blocks
BLOCK_PARENTS = {
    "inciter": {"<root>"},
    "walker": {"<root>"},
    "rngtest": {"<root>"},
    "transport": {"inciter"},
    "compflow": {"inciter"},
    "multimat": {"inciter"},
    "amr": {"inciter"},
    "coordref": {"amr"},
    "partitioning": {"inciter"},
    "pref": {"inciter"},
    "diagnostics": {"inciter"},
    "plotvar": {"inciter"},
    "field_output": {"inciter"},
    "material": {"compflow", "multimat"},
    "bc_dirichlet": {"transport", "compflow", "multimat"},
    "bc_sym": {"transport", "compflow", "multimat"},
    "bc_extrapolate": {"transport", "compflow", "multimat"},
    "bc_inlet": {"transport", "compflow", "multimat"},
    "bc_outlet": {"transport", "compflow", "multimat"},
    "rngs": {"walker", "rngtest"},
    "statistics": {"walker"},
    "pdfs": {"walker"},
    # walker SDE blocks
    "diag_ou": {"walker"},
    "ornstein-uhlenbeck": {"walker"},
    "beta": {"walker"},
    "numfracbeta": {"walker"},
    "massfracbeta": {"walker"},
    "mixnumfracbeta": {"walker"},
    "mixmassfracbeta": {"walker"},
    "dirichlet": {"walker"},
    "gendir": {"walker"},
    "mixdirichlet": {"walker"},
    "gamma": {"walker"},
    "skew-normal": {"walker"},
    "wright-fisher": {"walker"},
    "position": {"walker"},
    "dissipation": {"walker"},
    "velocity": {"walker"},
    # init-policy parameter blocks inside SDE blocks
    "icdelta": {"*sde*"},
    "icbeta": {"*sde*"},
    "icgaussian": {"*sde*"},
    "icjointgaussian": {"*sde*"},
    "icgamma": {"*sde*"},
    "icdirichlet": {"*sde*"},
    # the reference's rngtest decks put the battery block at root
    # (tests/regression/rngtest/Crush_r123_threefry.q)
    "smallcrush": {"rngtest", "<root>"},
    "crush": {"rngtest", "<root>"},
    "bigcrush": {"rngtest", "<root>"},
}

_SDE_BLOCKS = {
    "diag_ou", "ornstein-uhlenbeck", "beta", "numfracbeta", "massfracbeta",
    "mixnumfracbeta", "mixmassfracbeta", "dirichlet", "gendir",
    "mixdirichlet", "gamma", "skew-normal", "wright-fisher", "position",
    "dissipation", "velocity",
}

#: keywords whose value is a list of tokens terminated by `end`
LISTS = {
    "sideset", "gamma", "pstiff", "cv", "refvar",
    "sigmasq", "theta", "mu", "b", "S", "kappa", "bprime", "kappaprime",
    "rho2", "rcomma", "r", "rho", "cij", "omega", "T", "lambda", "u0",
    "diffusivity", "spike", "betapdf", "gammapdf", "gaussian",
    "dirichletpdf", "c",
    "edgelist", "coords", "hydrotimescales", "hydroproductions",
    "r123_philox", "r123_threefry",
}

#: keys that are LIST-valued in walker SDE blocks but SCALAR in these
#: inciter pde blocks (the reference grammar is context-sensitive the same
#: way: `kappa` is kw::pde_kappa, a single parameter, under compflow —
#: Grammar.hpp:729 — but a coefficient vector under the beta SDEs)
_SCALAR_IN = {
    "kappa": {"compflow", "multimat", "transport"},
    "b": {"compflow", "multimat", "transport"},
    "S": {"compflow", "multimat", "transport"},
    "r": {"compflow", "multimat", "transport"},
}

_TOKEN_RE = re.compile(r"<[^>]*>|\"[^\"]*\"|\S+")


def _tokenize(text: str) -> List[str]:
    out: List[str] = []
    for line in text.splitlines():
        line = line.split("#", 1)[0]
        for m in _TOKEN_RE.finditer(line):
            out.append(m.group(0))
    return out


def _opens_block(key: str, parent: str) -> bool:
    parents = BLOCK_PARENTS.get(key)
    if parents is None:
        return False
    if parent in parents:
        return True
    return "*sde*" in parents and parent in _SDE_BLOCKS


def parse_deck(text: str) -> Dict[str, Any]:
    """Parse deck text into a dict tree (values are occurrence lists)."""
    toks = _tokenize(text)
    pos = 0

    def parse_block(name: str, depth: int) -> Dict[str, Any]:
        nonlocal pos
        out: Dict[str, Any] = {}

        def store(k, v):
            out.setdefault(k, []).append(v)

        while pos < len(toks):
            t = toks[pos]
            pos += 1
            if t == "end":
                if depth == 0:
                    raise ValueError("unexpected 'end' at top level")
                return out
            key = t
            if name in ("rngs", "smallcrush", "crush", "bigcrush"):
                # each entry: rng name followed by its options until `end`
                # (e.g. `r123_philox seed 1 end`; battery blocks list the
                # rngs to subject to the battery the same way)
                vals = []
                while pos < len(toks) and toks[pos] != "end":
                    vals.append(toks[pos])
                    pos += 1
                pos += 1
                store(key, vals)
                continue
            if _opens_block(key, name):
                store(key, parse_block(key, depth + 1))
            elif key in LISTS and name != "rngs" \
                    and name not in _SCALAR_IN.get(key, ()):
                vals = []
                while pos < len(toks) and toks[pos] != "end":
                    vals.append(toks[pos])
                    pos += 1
                pos += 1  # consume end
                store(key, vals)
            elif key.startswith("<"):
                store("_moments", key)
            elif name == "pdfs" and (key.endswith("(") or "(" in key):
                # pdf spec: name( v1 v2 : b1 b2 [; lo1 hi1 lo2 hi2] )
                spec = [key]
                while pos < len(toks) and ")" not in toks[pos - 1]:
                    spec.append(toks[pos])
                    pos += 1
                store("_pdfs", " ".join(spec))
            elif key.startswith('"'):
                store("_strings", key.strip('"'))
            else:
                nxt = toks[pos] if pos < len(toks) else None
                takes_value = (
                    nxt is not None
                    and nxt != "end"
                    and not nxt.startswith("<")
                    and not _opens_block(nxt, name)
                    and name != "rngs"
                )
                if takes_value:
                    pos += 1
                    store(key, nxt.strip('"'))
                else:
                    store("_flags", key)
        if depth:
            raise ValueError(f"unterminated block {name!r}")
        return out

    return parse_block("<root>", 0)


def first(tree: Dict[str, Any], key: str, default=None):
    """First occurrence of key, or default."""
    v = tree.get(key)
    return v[0] if v else default


def occurrences(tree: Dict[str, Any], key: str) -> List[Any]:
    return tree.get(key, [])
