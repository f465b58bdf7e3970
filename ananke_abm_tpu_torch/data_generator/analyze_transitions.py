"""Transition analyzer (a copy of ``ananke_abm_tpu/data_generator/
analyze_transitions.py``; reference data_generator/analyze_transitions.py:
10): summarizes activity/mode transition patterns in persona timelines and flags
physically forbidden combinations (moving while stationary-purpose)."""
from __future__ import annotations

from collections import Counter

from ananke_abm_tpu_torch.data_generator.features import (
    ID_TO_MODE_MAP,
    ID_TO_PURPOSE_MAP,
    MODE_TABLE,
    PURPOSE_TABLE,
)
from ananke_abm_tpu_torch.data_generator.mock_world import (
    get_persona,
    persona_timeline,
)


def analyze_transitions(person_ids=(1, 2), verbose: bool = True) -> dict:
    """Returns {purpose_transitions, mode_transitions, forbidden} counters."""
    purpose_trans = Counter()
    mode_trans = Counter()
    forbidden = []

    for pid in person_ids:
        tl = persona_timeline(get_persona(pid))
        purp = tl["purpose_ids"]
        mode = tl["mode_ids"]
        for a, b in zip(purp[:-1], purp[1:]):
            purpose_trans[
                (ID_TO_PURPOSE_MAP[int(a)], ID_TO_PURPOSE_MAP[int(b)])
            ] += 1
        for a, b in zip(mode[:-1], mode[1:]):
            mode_trans[(ID_TO_MODE_MAP[int(a)], ID_TO_MODE_MAP[int(b)])] += 1
        # forbidden: a stationary purpose paired with a moving mode
        for t, (p, m) in enumerate(zip(purp, mode)):
            stationary = PURPOSE_TABLE[int(p), 0] > 0.5
            moving = MODE_TABLE[int(m), 0] > 0.5
            # events are snapshots: arriving BY a moving mode at a
            # stationary activity is fine; flag only stay-mode travel
            if not stationary and not moving:
                forbidden.append(
                    dict(person_id=pid, t=float(tl["times"][t]),
                         purpose=ID_TO_PURPOSE_MAP[int(p)],
                         mode=ID_TO_MODE_MAP[int(m)])
                )

    result = {
        "purpose_transitions": dict(purpose_trans),
        "mode_transitions": dict(mode_trans),
        "forbidden": forbidden,
    }
    if verbose:
        print(f"purpose transitions: {len(purpose_trans)} distinct")
        for (a, b), c in purpose_trans.most_common(10):
            print(f"  {a} -> {b}: {c}")
        print(f"mode transitions: {len(mode_trans)} distinct")
        if forbidden:
            print(f"FORBIDDEN combinations: {len(forbidden)}")
        else:
            print("no forbidden activity/mode combinations")
    return result
