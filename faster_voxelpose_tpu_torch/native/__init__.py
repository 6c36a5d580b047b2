"""Native host code of the port (C++ through ctypes): the heatmap
renderer and the image warp, built with g++ at first use (`build.py`)."""
