from .constants import (
    IGNORE_INDEX,
    NO_LABEL_INDEX,
    BOND_INDEX,
    MOL_PROPERTIES,
    SPECIAL_TOKENS,
)
from .logging import get_logger
