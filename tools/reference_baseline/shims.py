"""Import shims that let the UNMODIFIED reference at /root/reference run in
this environment: a ``numba`` stand-in routing its five @jit kernels to the
C++/OpenMP library (numba is not installable here — BASELINE.md), and a
minimal ``igraph`` stand-in with the exact Graph surface the reference uses
(SURVEY.md F9: add_vertex, delete_vertices, add/delete_edges, get_edgelist,
neighbors, simplify).

Measurement harness only — the framework never imports this.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import types

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))


def build_lib() -> ctypes.CDLL:
    so = os.path.join(_HERE, "libref_kernels.so")
    src = os.path.join(_HERE, "ref_kernels.cpp")
    if not os.path.exists(so) or os.path.getmtime(so) < os.path.getmtime(src):
        subprocess.check_call(
            ["g++", "-O3", "-march=native", "-fopenmp", "-shared", "-fPIC",
             src, "-o", so]
        )
    lib = ctypes.CDLL(so)
    return lib


def _ptr(a, dtype):
    a = np.ascontiguousarray(a, dtype=dtype)
    return a, a.ctypes.data_as(ctypes.c_void_p)


class _KernelDispatch:
    """ctypes wrappers matching the reference kernels' Python signatures."""

    def __init__(self):
        self.lib = build_lib()

    def assign_bins_jit(self, number_agents, bin_locations, bins, bins_help,
                        max_agents):
        bl, p_bl = _ptr(bin_locations, np.int64)
        assert bins.dtype == np.int64 and bins_help.dtype == np.int64
        bx, by, bz, cap = bins.shape
        self.lib.assign_bins(
            ctypes.c_int64(number_agents), p_bl,
            bins.ctypes.data_as(ctypes.c_void_p),
            bins_help.ctypes.data_as(ctypes.c_void_p),
            ctypes.c_int64(max_agents), ctypes.c_int64(bx), ctypes.c_int64(by),
            ctypes.c_int64(bz), ctypes.c_int64(cap),
        )
        return bins, bins_help

    def get_neighbors_cpu(self, number_agents, locations, bin_locations, bins,
                          bins_help, distance, edges, if_edge, edge_count,
                          max_neighbors):
        loc, p_loc = _ptr(locations, np.float64)
        bl, p_bl = _ptr(bin_locations, np.int64)
        bx, by, bz, cap = bins.shape
        self.lib.get_neighbors(
            ctypes.c_int64(number_agents), p_loc, p_bl,
            bins.ctypes.data_as(ctypes.c_void_p),
            bins_help.ctypes.data_as(ctypes.c_void_p),
            ctypes.c_double(distance),
            edges.ctypes.data_as(ctypes.c_void_p),
            if_edge.ctypes.data_as(ctypes.c_void_p),
            edge_count.ctypes.data_as(ctypes.c_void_p),
            ctypes.c_int64(max_neighbors), ctypes.c_int64(bx),
            ctypes.c_int64(by), ctypes.c_int64(bz), ctypes.c_int64(cap),
        )
        return edges, if_edge, edge_count

    def jkr_forces_cpu(self, number_edges, jkr_edges, delete_edges, locations,
                       radii, jkr_forces, poisson, youngs, adhesion_const):
        e, p_e = _ptr(jkr_edges, np.int64)
        loc, p_loc = _ptr(locations, np.float64)
        rad, p_rad = _ptr(radii, np.float64)
        self.lib.jkr_forces(
            ctypes.c_int64(number_edges), p_e,
            delete_edges.ctypes.data_as(ctypes.c_void_p), p_loc, p_rad,
            jkr_forces.ctypes.data_as(ctypes.c_void_p),
            ctypes.c_double(poisson), ctypes.c_double(youngs),
            ctypes.c_double(adhesion_const),
        )
        return jkr_forces, delete_edges

    def apply_forces_cpu(self, number_agents, jkr_force, motility_force,
                         locations, radii, stokes, size, move_dt):
        j, p_j = _ptr(jkr_force, np.float64)
        m, p_m = _ptr(motility_force, np.float64)
        rad, p_rad = _ptr(radii, np.float64)
        sz, p_sz = _ptr(size, np.float64)
        self.lib.apply_forces(
            ctypes.c_int64(number_agents), p_j, p_m,
            locations.ctypes.data_as(ctypes.c_void_p), p_rad,
            ctypes.c_double(stokes), p_sz, ctypes.c_double(move_dt),
        )
        return locations

    def update_diffusion_jit(self, base, steps, diffuse_dt, last_dt,
                             diffuse_const, spat_res2):
        nx, ny = base.shape
        self.lib.update_diffusion(
            base.ctypes.data_as(ctypes.c_void_p), ctypes.c_int64(nx),
            ctypes.c_int64(ny), ctypes.c_int64(steps),
            ctypes.c_double(diffuse_dt), ctypes.c_double(last_dt),
            ctypes.c_double(diffuse_const), ctypes.c_double(spat_res2),
        )
        return base


def make_numba_shim() -> types.ModuleType:
    dispatch = _KernelDispatch()
    numba = types.ModuleType("numba")

    def jit(*args, **kwargs):
        def deco(fn):
            impl = getattr(dispatch, fn.__name__, None)
            return impl if impl is not None else fn

        if args and callable(args[0]):
            return deco(args[0])
        return deco

    class _Cuda(types.ModuleType):
        def jit(self, *a, **k):
            def deco(fn):
                return fn

            if a and callable(a[0]):
                return deco(a[0])
            return deco

        @staticmethod
        def is_available():
            return False

    numba.jit = jit
    numba.njit = jit
    numba.prange = range
    numba.cuda = _Cuda("numba.cuda")
    return numba


class ShimGraph:
    """The igraph.Graph surface the reference uses, on numpy edge arrays with
    cached adjacency (mirrors hipsc_abm.simulation.AgentGraph)."""

    def __init__(self, n=0):
        self._n = int(n)
        self.edges = np.zeros((0, 2), dtype=np.int64)
        self._adj = None

    # -- helpers ------------------------------------------------------------
    def _adjacency(self):
        if self._adj is None:
            adj = [[] for _ in range(self._n)]
            for a, b in self.edges:
                adj[a].append(int(b))
                adj[b].append(int(a))
            self._adj = adj
        return self._adj

    # -- igraph surface -----------------------------------------------------
    def vcount(self):
        return self._n

    def add_vertex(self):
        self._n += 1
        self._adj = None

    def add_vertices(self, k):
        self._n += int(k)
        self._adj = None

    def add_edges(self, edges):
        edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
        self.edges = np.concatenate([self.edges, edges], axis=0)
        self._adj = None

    def delete_edges(self, which):
        if which is None:
            self.edges = np.zeros((0, 2), dtype=np.int64)
        else:
            idx = np.asarray(which, dtype=np.int64)
            self.edges = np.delete(self.edges, idx, axis=0)
        self._adj = None

    def delete_vertices(self, indices):
        indices = np.unique(np.asarray(indices, dtype=np.int64))
        keep_mask = np.ones(self._n, dtype=bool)
        keep_mask[indices] = False
        remap = np.cumsum(keep_mask) - 1
        e = self.edges
        ok = keep_mask[e[:, 0]] & keep_mask[e[:, 1]]
        self.edges = remap[e[ok]]
        self._n -= len(indices)
        self._adj = None

    def get_edgelist(self):
        return [tuple(r) for r in self.edges]

    def neighbors(self, index):
        return self._adjacency()[index]

    def simplify(self):
        if len(self.edges):
            lo = np.minimum(self.edges[:, 0], self.edges[:, 1])
            hi = np.maximum(self.edges[:, 0], self.edges[:, 1])
            undirected = np.stack([lo, hi], axis=1)
            undirected = np.unique(undirected, axis=0)
            self.edges = undirected[undirected[:, 0] != undirected[:, 1]]
        self._adj = None
        return self


def make_igraph_shim() -> types.ModuleType:
    igraph = types.ModuleType("igraph")
    igraph.Graph = ShimGraph
    return igraph


def install():
    """Install the shims and module aliases so /root/reference imports run."""
    sys.modules.setdefault("numba", make_numba_shim())
    sys.modules.setdefault("igraph", make_igraph_shim())
