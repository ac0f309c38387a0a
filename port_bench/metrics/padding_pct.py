"""padding_pct: the share of the tokens the engine ran that were padding.

100 × (1 − `prostt5.residues` / `prostt5.padded_tokens`), the engine's
own counters (ProstT5Engine._predict_units) over the window: the
framing's prefix and eos, the length buckets of 128 and the batch rows
padded to a multiple of 8.  None where the window counted no token.
"""


def read(run):
    padded = run.counters.get("prostt5.padded_tokens", 0.0)
    if padded <= 0:
        return None
    return 100.0 * (1.0 - run.counters.get("prostt5.residues", 0.0) / padded)
