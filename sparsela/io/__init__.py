from sparsela.io.market import read_market, write_market
from sparsela.io.plans import (
    cached_plan,
    load_plan,
    plan_info,
    save_plan,
)
from sparsela.io.generators import (
    make_dense,
    make_wheel,
    make_grid2d,
    make_grid3d,
    make_random_spd,
)
