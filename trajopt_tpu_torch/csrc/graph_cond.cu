// Device-side control flow: CUDA conditional graph nodes (IF, IF/ELSE and
// WHILE) and the kernel that sets their condition.
//
// Replaces what XLA lowers `lax.cond` and `lax.while_loop` to inside the JAX
// package's fused drivers (trajopt_tpu/solver/driver.py:318, :361, :401, the
// `lax.cond`s of trajopt_tpu/ops/ccd.py, solver/admm.py and solver/multi.py,
// the shrink loop of solver/multi.py:349): a branch index, or a loop
// condition, read by the device from a predicate buffer, so that the side
// not taken never runs and a loop stops when its condition fails, with no
// host round-trip.  There is no Pallas kernel for it.
//
// `set_condition` is one thread: it reads a 0-d bool tensor on the card
// (optionally negated) and hands it to `cudaGraphSetConditional`, which
// decides whether the conditional node that owns ``handle`` runs its body
// (IF), which of its two bodies (IF/ELSE), or whether it runs its body once
// more (WHILE, when called at the end of that body).  Bound on the card:
// latency, one dependent load of one byte; the node launch around it is the
// graph's cost.
//
// The host entry points build the nodes while torch captures a stream into
// its CUDA graph: `trajopt_cond_handle` creates a handle in the graph the
// stream is capturing into (reset to 0 at each launch of the graph),
// `trajopt_cond_node` adds the conditional node after the stream's current
// capture dependencies and makes it the only one, so the capture continues
// after the node, and `trajopt_capture_body` / `trajopt_end_body` capture a
// second stream into one of the node's body graphs.  Every entry point
// returns its cudaError_t; none synchronizes.
//
// `trace_mark` is the tracing's mark between two phases of a captured step
// (trajopt_tpu_torch/runtime/trace.py): one thread that writes a mark id and
// the card's %globaltimer (ns) at the index a counter in device memory
// holds, and advances it.  Past the buffer's capacity it writes nothing, so
// the counter's excess is the marks dropped.  As a node of the graph it runs
// after the node before it has finished, so consecutive marks bound the
// device time of the work between them.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

__global__ void set_condition_kernel(cudaGraphConditionalHandle handle, const unsigned char* pred,
                                     unsigned int negate, long long* tally) {
    const unsigned int value = (pred[0] != 0 ? 1u : 0u) ^ negate;
    cudaGraphSetConditional(handle, value);
    if (tally != nullptr) {   // evaluations of the node, and times its body was taken
        tally[0] += 1;
        tally[1] += value;
    }
}

__global__ void trace_mark_kernel(long long* marks, long long* head, long long capacity,
                                  long long id) {
    unsigned long long now;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
    const long long i = head[0];
    head[0] = i + 1;
    if (i < capacity) {
        marks[2 * i] = id;
        marks[2 * i + 1] = static_cast<long long>(now);
    }
}

// The graph that `stream` is capturing into, and its capture dependencies.
cudaError_t capturing_graph(cudaStream_t stream, cudaGraph_t* graph, const cudaGraphNode_t** deps,
                            size_t* ndeps) {
    cudaStreamCaptureStatus status;
#if CUDART_VERSION >= 13000
    cudaError_t err = cudaStreamGetCaptureInfo(stream, &status, nullptr, graph, deps, nullptr, ndeps);
#else
    cudaError_t err = cudaStreamGetCaptureInfo(stream, &status, nullptr, graph, deps, ndeps);
#endif
    if (err != cudaSuccess) return err;
    return status == cudaStreamCaptureStatusActive ? cudaSuccess : cudaErrorIllegalState;
}

}  // namespace

extern "C" int trajopt_set_condition(unsigned long long handle, const void* pred, int negate,
                                     void* tally, void* stream) {
    set_condition_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<cudaGraphConditionalHandle>(handle), static_cast<const unsigned char*>(pred),
        negate ? 1u : 0u, static_cast<long long*>(tally));
    return static_cast<int>(cudaGetLastError());
}

// marks: int64 [capacity, 2] (id, ns); head: int64 [1], the next index.
extern "C" int trajopt_mark(void* marks, void* head, long long capacity, long long id,
                            void* stream) {
    trace_mark_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<long long*>(marks), static_cast<long long*>(head), capacity, id);
    return static_cast<int>(cudaGetLastError());
}

// out[0]: the CUDA runtime's version (the static runtime linked here),
// out[1]: the driver's.
extern "C" int trajopt_cond_probe(int* out) {
    cudaError_t err = cudaRuntimeGetVersion(&out[0]);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaDriverGetVersion(&out[1]));
}

// A conditional handle in the graph `stream` is capturing into, its value
// reset to 0 at each launch of the graph; `graph_out` is that graph.
extern "C" int trajopt_cond_handle(void* stream, unsigned long long* handle, void** graph_out) {
    cudaGraph_t graph;
    const cudaGraphNode_t* deps;
    size_t ndeps;
    cudaError_t err = capturing_graph(static_cast<cudaStream_t>(stream), &graph, &deps, &ndeps);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaGraphConditionalHandle h;
    err = cudaGraphConditionalHandleCreate(&h, graph, 0, cudaGraphCondAssignDefault);
    if (err != cudaSuccess) return static_cast<int>(err);
    *handle = static_cast<unsigned long long>(h);
    *graph_out = graph;
    return 0;
}

// Adds a conditional node on `handle` (kind 0: IF with `size` 1 or 2
// bodies, the second the ELSE; kind 1: WHILE) after the capture
// dependencies of `stream`, and makes the node the stream's only
// dependency.  bodies[0 .. size-1]: the node's body graphs, empty.
extern "C" int trajopt_cond_node(void* stream, unsigned long long handle, int kind, int size,
                                 void** bodies) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (kind < 0 || kind > 1 || size < 1 || size > 2 || (kind == 1 && size != 1)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaGraph_t graph;
    const cudaGraphNode_t* deps;
    size_t ndeps;
    cudaError_t err = capturing_graph(s, &graph, &deps, &ndeps);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaGraphNodeParams params = {};
    params.type = cudaGraphNodeTypeConditional;
    params.conditional.handle = static_cast<cudaGraphConditionalHandle>(handle);
    params.conditional.type = kind == 0 ? cudaGraphCondTypeIf : cudaGraphCondTypeWhile;
    params.conditional.size = static_cast<unsigned int>(size);
    cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
    err = cudaGraphAddNode(&node, graph, deps, nullptr, ndeps, &params);
#else
    err = cudaGraphAddNode(&node, graph, deps, ndeps, &params);
#endif
    if (err != cudaSuccess) return static_cast<int>(err);
    for (int i = 0; i < size; ++i) bodies[i] = params.conditional.phGraph_out[i];
#if CUDART_VERSION >= 13000
    err = cudaStreamUpdateCaptureDependencies(s, &node, nullptr, 1, cudaStreamSetCaptureDependencies);
#else
    err = cudaStreamUpdateCaptureDependencies(s, &node, 1, cudaStreamSetCaptureDependencies);
#endif
    return static_cast<int>(err);
}

// A non-blocking stream of the current device, for capturing bodies on.
extern "C" int trajopt_stream_create(void** stream) {
    cudaStream_t s = nullptr;
    cudaError_t err = cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking);
    *stream = s;
    return static_cast<int>(err);
}

// Starts capturing `stream` into the body graph `body` (thread-local mode).
extern "C" int trajopt_capture_body(void* stream, void* body) {
    return static_cast<int>(cudaStreamBeginCaptureToGraph(
        static_cast<cudaStream_t>(stream), static_cast<cudaGraph_t>(body), nullptr, nullptr, 0,
        cudaStreamCaptureModeThreadLocal));
}

// Ends the capture of `stream`; `graph_out` is the graph it captured into.
extern "C" int trajopt_end_body(void* stream, void** graph_out) {
    cudaGraph_t graph = nullptr;
    cudaError_t err = cudaStreamEndCapture(static_cast<cudaStream_t>(stream), &graph);
    *graph_out = graph;
    return static_cast<int>(err);
}
