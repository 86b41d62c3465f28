"""Seeded road networks on the grid scenario, for holding the road-network
reward and the road stage against a reference (the CPU tests against the
JAX package, ``chip_smoke.py`` the card against the CPU).

The grid's initial plan is a 4 x 4 block network of 40 road segments on
the lines x, y in {0, 60, 120, 190, 240} (grid units, 10 m cells). Every
function here takes and returns a state as a dict of numpy arrays under
the JAX PlanState's field names (``state.plan_state_to_numpy``), so that
the same state can be built in either package.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from urban_tpu_torch.host import city_config

# horizontal walls through the four interior blocks (x 60..190, y 50..180),
# attached alternately to the left and the right side: with the interior
# roads at x = 120 and y = 120 removed they leave one winding corridor,
# which the face decomposition needs several sweeps to flood
SERPENTINE = tuple(((60.0, y), (174.0, y)) if i % 2 == 0 else
                   ((76.0, y), (190.0, y))
                   for i, y in enumerate((66.0, 82.0, 98.0, 114.0, 130.0,
                                          146.0, 162.0)))
# non-axis-aligned roads: the first crosses the face that removing the
# road (120, 50)-(120, 120) opens, and splits it in two
DIAGONALS = (((60.0, 50.0), (190.0, 120.0)), ((60.0, 120.0), (120.0, 180.0)),
             ((120.0, 120.0), (190.0, 180.0)))


def _segs(d: Dict[str, np.ndarray]) -> np.ndarray:
    return d['seg_flat'].reshape(-1, 2, 2)


def _find(d, a, b) -> int:
    """Slot of the alive segment with endpoints a and b (either order)."""
    seg = _segs(d)
    ab, ba = np.array([a, b]), np.array([b, a])
    hit = d['seg_alive'] & ((seg == ab).all((1, 2)) | (seg == ba).all((1, 2)))
    (slot,) = np.nonzero(hit)[0]
    return int(slot)


def to_boundary(d, slots: Sequence[int]) -> Dict[str, np.ndarray]:
    """d with the given segments turned from roads into boundaries."""
    d = {k: np.array(v) for k, v in d.items()}
    d['seg_type'][list(slots)] = city_config.BOUNDARY
    return d


def add_roads(d, roads) -> Dict[str, np.ndarray]:
    """d with new road segments ((x0, y0), (x1, y1)) in its first free
    segment slots."""
    d = {k: np.array(v) for k, v in d.items()}
    free = np.nonzero(~d['seg_alive'])[0][:len(roads)]
    seg = _segs(d)
    for slot, (a, b) in zip(free, roads):
        seg[slot] = (a, b)
        d['seg_type'][slot] = city_config.ROAD
        d['seg_alive'][slot] = True
    d['seg_flat'] = seg.reshape(d['seg_flat'].shape)
    return d


def road_slots(d) -> np.ndarray:
    return np.nonzero(d['seg_alive'] & (d['seg_type'] == city_config.ROAD))[0]


def reward_states(init: Dict[str, np.ndarray], seed: int = 0
                  ) -> Dict[str, Dict[str, np.ndarray]]:
    """Named road networks that cover each branch of the reward: the
    initial plan; seeded random subsets of its roads turned into
    boundaries (components, dead ends, merged faces); the serpentine
    corridor (several sweeps); one, two and three diagonal roads (the
    diagonal branch of the face decomposition)."""
    rng = np.random.default_rng(seed)
    roads = road_slots(init)
    out = {'initial': init}
    for k, frac in enumerate((0.15, 0.3, 0.5)):
        pick = roads[rng.random(len(roads)) < frac]
        out[f'boundaries_{k}'] = to_boundary(init, pick)
    opened = to_boundary(init, [_find(init, (120.0, 50.0), (120.0, 120.0)),
                                _find(init, (120.0, 120.0), (120.0, 180.0)),
                                _find(init, (60.0, 120.0), (120.0, 120.0)),
                                _find(init, (120.0, 120.0), (190.0, 120.0))])
    out['serpentine'] = add_roads(opened, SERPENTINE)
    cut = to_boundary(init, [_find(init, (120.0, 50.0), (120.0, 120.0))])
    for n in (1, 2, 3):
        out[f'diagonal_{n}'] = add_roads(cut, DIAGONALS[:n])
    return out


def random_road_states(init: Dict[str, np.ndarray], seed: int, batch: int
                       ) -> Dict[str, np.ndarray]:
    """A batch of seeded networks, stacked on a leading axis: each with a
    random subset of the initial roads turned into boundaries, some of the
    serpentine walls and, in one state out of four, one to three diagonal
    roads."""
    rng = np.random.default_rng(seed)
    roads = road_slots(init)
    states = []
    for _ in range(batch):
        d = to_boundary(init, roads[rng.random(len(roads))
                                    < rng.uniform(0.0, 0.5)])
        walls = [w for w in SERPENTINE if rng.random() < 0.5]
        if rng.random() < 0.25:
            walls += list(DIAGONALS[:int(rng.integers(1, 4))])
        states.append(add_roads(d, walls))
    return {k: np.stack([s[k] for s in states]) for k in init}


def road_stage_state(init: Dict[str, np.ndarray], road_ratio: float,
                     seed: int, frac: float = 0.5) -> Dict[str, np.ndarray]:
    """A grid state at the start of its road stage: a seeded subset of the
    initial roads (each with probability frac, at least one) turned into
    boundaries, stage 1, and the road budget the land-use completion would
    set, floor(boundaries x road_ratio)."""
    rng = np.random.default_rng(seed)
    roads = road_slots(init)
    pick = roads[rng.random(len(roads)) < frac]
    if len(pick) == 0:
        pick = roads[:1]
    d = to_boundary(init, pick)
    n_boundary = int((d['seg_alive']
                      & (d['seg_type'] == city_config.BOUNDARY)).sum())
    d['stage'] = np.array(1, dtype=d['stage'].dtype)
    d['total_road_steps'] = np.array(int(np.floor(n_boundary * road_ratio)),
                                     dtype=d['total_road_steps'].dtype)
    return d
