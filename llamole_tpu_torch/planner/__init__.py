from .search import retro_star_search, retro_star_search_multi, molstar
from .route import SynthesisRoute
