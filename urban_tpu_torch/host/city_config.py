"""Land-use type system for the urban-planning framework.

TPU-native rebuild of the reference type constants
(reference: urban_planning/envs/city_config.py:1-99). Integer ids are part of the
scenario-data contract (init-plan 'type' columns use them), so they match exactly.
"""
from types import MappingProxyType

NON_BLOCK_LAND_USE = ('outside', 'feasible', 'road', 'boundary')

BLOCK_LAND_USE = (
    'residential',
    'business',
    'office',
    'green_l',
    'green_s',
    'school',
    'hospital_l',
    'hospital_s',
    'recreation',
)

LAND_USE = NON_BLOCK_LAND_USE + BLOCK_LAND_USE

OUTSIDE = 0
FEASIBLE = 1
ROAD = 2
BOUNDARY = 3
RESIDENTIAL = 4
BUSINESS = 5
OFFICE = 6
GREEN_L = 7
GREEN_S = 8
SCHOOL = 9
HOSPITAL_L = 10
HOSPITAL_S = 11
RECREATION = 12

LAND_USE_ID = (
    OUTSIDE,
    FEASIBLE,
    ROAD,
    BOUNDARY,
    RESIDENTIAL,
    BUSINESS,
    OFFICE,
    GREEN_L,
    GREEN_S,
    SCHOOL,
    HOSPITAL_L,
    HOSPITAL_S,
    RECREATION,
)

NUM_TYPES = len(LAND_USE_ID)

LAND_USE_ID_MAP = MappingProxyType(dict(zip(LAND_USE, LAND_USE_ID)))
LAND_USE_ID_MAP_INV = MappingProxyType(dict(zip(LAND_USE_ID, LAND_USE)))

# Road intersections get their own node type one past the land uses
# (reference: city_config.py:61).
INTERSECTION = 13

# Public services scored by the 15-minute life circle reward. The two hospital
# scales count as one service category (reference: city_config.py:63-77).
PUBLIC_SERVICES_ID = (
    BUSINESS,
    OFFICE,
    SCHOOL,
    (HOSPITAL_L, HOSPITAL_S),
    RECREATION,
)

PUBLIC_SERVICES = (
    'shopping',
    'working',
    'education',
    'medical care',
    'entertainment',
)

GREEN_ID = (GREEN_L, GREEN_S)
# Only green areas of at least this many square meters contribute green cover
# (reference: city_config.py:83).
GREEN_AREA_THRESHOLD = 2000.0

TYPE_COLOR_MAP = MappingProxyType({
    'boundary': 'lightgreen',
    'business': 'fuchsia',
    'feasible': 'white',
    'green_l': 'green',
    'green_s': 'lightgreen',
    'hospital_l': 'blue',
    'hospital_s': 'cyan',
    'office': 'gold',
    'outside': 'black',
    'residential': 'yellow',
    'road': 'red',
    'school': 'darkorange',
    'recreation': 'lavender',
})
