// Host-side topology preprocessing for the port, plain C ABI for ctypes.
//
// The port's own copy of the five O(N+E) functions of the JAX package's
// native/topology_kernels.cpp, loaded by troute_torch/native.py.  At CONUS
// scale (2.7M nodes) they take milliseconds where the NumPy fallbacks of
// troute_torch/network/topology.py, routing/upstream_plan.py and
// parallel/partition.py take seconds; both give identical arrays, and
// connected_components the same partition into basins.

#include <cstdint>
#include <vector>

extern "C" {

// Longest-path-from-headwater wavefront level per node.
// downstream[i] = index of downstream node or -1.  Returns 0 on success,
// 1 if a cycle is detected (levels then undefined).
int wavefront_levels(const int32_t* downstream, int64_t n, int32_t* levels) {
    std::vector<int32_t> indeg(n, 0);
    for (int64_t i = 0; i < n; ++i) {
        int32_t d = downstream[i];
        if (d >= 0) indeg[d]++;
    }
    std::vector<int64_t> queue;
    queue.reserve(n);
    for (int64_t i = 0; i < n; ++i) {
        levels[i] = 0;
        if (indeg[i] == 0) queue.push_back(i);
    }
    int64_t processed = 0;
    for (int64_t head = 0; head < (int64_t)queue.size(); ++head) {
        int64_t u = queue[head];
        ++processed;
        int32_t d = downstream[u];
        if (d >= 0) {
            int32_t cand = levels[u] + 1;
            if (cand > levels[d]) levels[d] = cand;
            if (--indeg[d] == 0) queue.push_back(d);
        }
    }
    return processed == n ? 0 : 1;
}

// Connected-component label per node (union along downstream edges).
// Labels are root indices remapped to 0..k-1 in first-appearance order.
// Returns the component count.
int connected_components(const int32_t* downstream, int64_t n,
                         int32_t* labels) {
    std::vector<int64_t> parent(n);
    for (int64_t i = 0; i < n; ++i) parent[i] = i;

    // iterative find with path halving
    auto find = [&](int64_t a) {
        while (parent[a] != a) {
            parent[a] = parent[parent[a]];
            a = parent[a];
        }
        return a;
    };
    for (int64_t i = 0; i < n; ++i) {
        int32_t d = downstream[i];
        if (d >= 0) {
            int64_t ra = find(i), rb = find(d);
            if (ra != rb) parent[ra] = rb;
        }
    }
    std::vector<int32_t> remap(n, -1);
    int32_t next = 0;
    for (int64_t i = 0; i < n; ++i) {
        int64_t r = find(i);
        if (remap[r] < 0) remap[r] = next++;
        labels[i] = remap[r];
    }
    return next;
}

// Padded upstream (reverse) adjacency: for each node, up to k upstream
// node indices (-1 padded), in ascending row order.  Returns the max
// in-degree; if it exceeds k the caller must retry with a larger k
// (nothing is written then).
int32_t invert_downstream(const int32_t* downstream, int64_t n, int32_t k,
                          int32_t* upstream /* [n*k], -1 initialized */) {
    std::vector<int32_t> count(n, 0);
    int32_t maxdeg = 0;
    for (int64_t i = 0; i < n; ++i) {
        int32_t d = downstream[i];
        if (d >= 0) {
            int32_t c = ++count[d];
            if (c > maxdeg) maxdeg = c;
        }
    }
    if (maxdeg > k) return maxdeg;
    for (int64_t i = 0; i < n; ++i) count[i] = 0;
    for (int64_t i = 0; i < n; ++i) {
        int32_t d = downstream[i];
        if (d >= 0) upstream[(int64_t)d * k + count[d]++] = (int32_t)i;
    }
    return maxdeg;
}

// Post-order DFS of the drainage forest: children before parents,
// subtrees contiguous, tailwaters ascending, children in upstream-column
// order (the visit order of the NumPy fallback).  Writes the [n] mapping
// new position -> original row; returns the count written (== n iff the
// graph is a forest).
int64_t postorder_forest(const int32_t* downstream, const int32_t* upstream,
                         int64_t n, int32_t k, int64_t* order) {
    std::vector<int32_t> ci(n, 0);
    std::vector<uint8_t> visited(n, 0);
    std::vector<int64_t> stack;
    stack.reserve(1024);
    int64_t pos = 0;
    for (int64_t t = 0; t < n; ++t) {
        if (downstream[t] >= 0) continue;
        stack.push_back(t);
        while (!stack.empty()) {
            int64_t v = stack.back();
            const int32_t* kids = upstream + v * (int64_t)k;
            int32_t c = ci[v];
            while (c < k && (kids[c] < 0 || visited[kids[c]])) ++c;
            if (c < k) {
                ci[v] = c + 1;
                stack.push_back(kids[c]);
            } else {
                ci[v] = c;
                stack.pop_back();
                visited[v] = 1;
                order[pos++] = v;
            }
        }
    }
    return pos;
}

// Cut a drainage forest into connected parts of size <= cap by cutting
// tree edges (a forest sliced into P connected parts costs exactly
// P - n_basins edge cuts, the fewest possible).  One O(N+E) pass in
// topological order: each node accumulates its uncut children; a child
// whose inclusion would push the parent past cap is cut at its top edge
// and becomes its own part, as does any node reaching cap itself.
// part[i] receives a dense part id; ids follow first appearance in
// reverse topological order.  Returns the part count, or -1 on a cycle.
int64_t tree_cut_parts(const int32_t* downstream, int64_t n, int64_t cap,
                       int32_t* part) {
    std::vector<int32_t> indeg(n, 0);
    for (int64_t i = 0; i < n; ++i) {
        int32_t d = downstream[i];
        if (d >= 0) indeg[d]++;
    }
    std::vector<int64_t> order;
    order.reserve(n);
    for (int64_t i = 0; i < n; ++i)
        if (indeg[i] == 0) order.push_back(i);
    std::vector<int64_t> acc(n, 1);
    std::vector<uint8_t> cut(n, 0);
    for (int64_t head = 0; head < (int64_t)order.size(); ++head) {
        int64_t u = order[head];
        int32_t d = downstream[u];
        if (acc[u] >= cap) cut[u] = 1;            // a full part rooted at u
        if (d >= 0) {
            if (!cut[u]) {
                if (acc[d] + acc[u] > cap) cut[u] = 1;   // would overflow
                else acc[d] += acc[u];
            }
            if (--indeg[d] == 0) order.push_back(d);
        }
    }
    if ((int64_t)order.size() != n) return -1;    // cycle
    int32_t next = 0;
    for (int64_t head = n - 1; head >= 0; --head) {
        int64_t u = order[head];                  // parents before children
        int32_t d = downstream[u];
        if (cut[u] || d < 0) part[u] = next++;
        else part[u] = part[d];
    }
    return next;
}

}  // extern "C"
