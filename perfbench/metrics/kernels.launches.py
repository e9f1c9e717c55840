"""Launches a request of the port's own CUDA kernels
(``kernels.launch_counts()``): an exact count that shows the route. The
fused scan launches three a request; the plain path (matmul and sort)
none."""


def read(r):
    if not r.requests:
        return None
    return sum(r.launches.values()) / r.n_requests
