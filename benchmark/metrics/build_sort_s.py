"""build_sort_s: the seconds of the suffix sort on the card, the stage
``build.sort`` of the program's record of its latest build
(``bwt_tpu_torch.index.LAST_BUILD``, ending in a synchronise); None where
the program keeps no such record, or where the build ran on no card (its
stage keeps no allocator peak): a CPU's sort is not the card's."""

import sys

STAGE = "build.sort"


def read(run):
    record = getattr(sys.modules.get("bwt_tpu_torch.index"), "LAST_BUILD",
                     None)
    if getattr(record, "peaks", {}).get(STAGE) is None:
        return None
    return record.totals[STAGE]
