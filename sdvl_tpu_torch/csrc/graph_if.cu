// IF and WHILE nodes of a CUDA graph, added while a stream captures (CUDA
// 12.4+: a conditional node nested in another's body needs 12.4).
//
// A graph captured from eager PyTorch code records the kernels of one path
// through the code. The SLAM step branches on device values (is the stream
// LOST, was the frame good, is it a keyframe); as a graph, each branch is a
// conditional node whose body runs only where a () bool tensor on the device
// is true when the graph replays. This file adds such a node to the graph a
// stream is capturing, and starts a second stream capturing into its body:
//
//   sdvl_if_begin(parent, body, pred, counter)
//     1. a one-thread kernel on `parent` copies *pred into a new conditional
//        handle (cudaGraphSetConditional) each time the graph runs, and adds
//        1 to the uint64 *counter (unless it is null);
//     2. an IF node on that handle, after the kernel, becomes the sole
//        dependency of whatever `parent` captures next;
//     3. `body` begins capturing into the node's body graph.
//   sdvl_if_end(body)
//     ends the body's capture.
//
// A loop is a WHILE node, whose body runs again as long as its handle is
// non-zero when the body ends:
//
//   sdvl_while_begin(parent, body, pred, counter, &handle)
//     as sdvl_if_begin, with a WHILE node; the kernel before the node sets
//     the handle from *pred, so the body may run zero times;
//   sdvl_while_end(body, handle, pred, counter)
//     captures the same kernel at the end of the body, on *pred as the body
//     left it (the caller recomputes it there), then ends the body's capture.
//
// The caller runs the body's work on `body` in between. Nesting works the
// same way, the body stream of one level being the parent of the next.
// Nothing here synchronises or allocates device memory. Each function returns
// a cudaError_t as an int (0 = success).
//
// This is the counterpart of the `lax.cond` / `lax.switch`, `while_loop`,
// `fori_loop` and `scan` of the reference's device programs
// (sdvl_tpu/pipeline/device_fsm.py, sdvl_tpu/solvers/ba.py); it replaces no
// Pallas kernel.

#include <cuda_runtime.h>

// Sets the node's handle from *pred, and counts its launches in *counter
// (where one is given): one per IF node and one per WHILE iteration, plus
// one per WHILE node, each time the graph replays.
__global__ void set_condition_kernel(cudaGraphConditionalHandle handle,
                                     const bool* pred,
                                     unsigned long long* counter) {
    cudaGraphSetConditional(handle, *pred ? 1u : 0u);
    if (counter != nullptr) atomicAdd(counter, 1ull);
}

// the step of the last failed call (for the caller's error message)
static thread_local int last_step = 0;

extern "C" int sdvl_last_step() { return last_step; }

#define STEP(n, call)                                                  \
    do {                                                               \
        const cudaError_t e_ = (call);                                 \
        if (e_ != cudaSuccess) {                                       \
            last_step = (n);                                           \
            return static_cast<int>(e_);                               \
        }                                                              \
    } while (0)

static int conditional_begin(void* parent_stream, void* body_stream,
                             const void* pred, void* counter,
                             cudaGraphConditionalNodeType type,
                             cudaGraphConditionalHandle* handle_out) {
    const cudaStream_t parent = static_cast<cudaStream_t>(parent_stream);
    const cudaStream_t body = static_cast<cudaStream_t>(body_stream);
    cudaStreamCaptureStatus status;
    cudaGraph_t graph;
    const cudaGraphNode_t* deps = nullptr;
    size_t n_deps = 0;
    STEP(1, cudaStreamGetCaptureInfo(parent, &status, nullptr, &graph, &deps,
                                     &n_deps));
    if (status != cudaStreamCaptureStatusActive) {
        last_step = 2;
        return static_cast<int>(cudaErrorStreamCaptureImplicit);
    }
    cudaStreamCaptureStatus body_status;
    STEP(3, cudaStreamIsCapturing(body, &body_status));
    if (body_status != cudaStreamCaptureStatusNone) {
        last_step = 4;          // the body stream is capturing already
        return static_cast<int>(cudaErrorIllegalState);
    }

    cudaGraphConditionalHandle handle;
    STEP(5, cudaGraphConditionalHandleCreate(&handle, graph, 0,
                                             cudaGraphCondAssignDefault));
    set_condition_kernel<<<1, 1, 0, parent>>>(
        handle, static_cast<const bool*>(pred),
        static_cast<unsigned long long*>(counter));
    STEP(6, cudaGetLastError());

    // the conditional node goes after the kernel just captured
    STEP(7, cudaStreamGetCaptureInfo(parent, &status, nullptr, &graph, &deps,
                                     &n_deps));
    cudaGraphNodeParams params = {};
    params.type = cudaGraphNodeTypeConditional;
    params.conditional.handle = handle;
    params.conditional.type = type;
    params.conditional.size = 1;
    cudaGraphNode_t node;
    STEP(8, cudaGraphAddNode(&node, graph, deps, n_deps, &params));
    STEP(9, cudaStreamUpdateCaptureDependencies(
        parent, &node, 1, cudaStreamSetCaptureDependencies));
    if (handle_out != nullptr) *handle_out = handle;
    STEP(10, cudaStreamBeginCaptureToGraph(
        body, params.conditional.phGraph_out[0], nullptr, nullptr, 0,
        cudaStreamCaptureModeThreadLocal));
    return 0;
}

extern "C" int sdvl_if_begin(void* parent_stream, void* body_stream,
                             const void* pred, void* counter) {
    return conditional_begin(parent_stream, body_stream, pred, counter,
                             cudaGraphCondTypeIf, nullptr);
}

extern "C" int sdvl_if_end(void* body_stream) {
    cudaGraph_t graph;
    return static_cast<int>(
        cudaStreamEndCapture(static_cast<cudaStream_t>(body_stream), &graph));
}

extern "C" int sdvl_while_begin(void* parent_stream, void* body_stream,
                                const void* pred, void* counter,
                                unsigned long long* handle_out) {
    cudaGraphConditionalHandle handle = 0;
    const int err = conditional_begin(parent_stream, body_stream, pred,
                                      counter, cudaGraphCondTypeWhile,
                                      &handle);
    *handle_out = static_cast<unsigned long long>(handle);
    return err;
}

extern "C" int sdvl_while_end(void* body_stream, unsigned long long handle,
                              const void* pred, void* counter) {
    const cudaStream_t body = static_cast<cudaStream_t>(body_stream);
    set_condition_kernel<<<1, 1, 0, body>>>(
        static_cast<cudaGraphConditionalHandle>(handle),
        static_cast<const bool*>(pred),
        static_cast<unsigned long long*>(counter));
    const cudaError_t launched = cudaGetLastError();
    cudaGraph_t graph;
    // end the capture whatever the launch gave, so the stream is usable
    const cudaError_t ended = cudaStreamEndCapture(body, &graph);
    return static_cast<int>(launched != cudaSuccess ? launched : ended);
}

// The CUDA runtime's and the driver's versions (1000 * major + 10 * minor).
extern "C" int sdvl_cuda_versions(int* runtime, int* driver) {
    cudaError_t err = cudaRuntimeGetVersion(runtime);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaDriverGetVersion(driver));
}

// A new non-blocking stream of the current device, for a conditional body
// (*stream_out; never destroyed: one per nesting depth per device).
extern "C" int sdvl_stream_create(void** stream_out) {
    cudaStream_t stream;
    const cudaError_t err =
        cudaStreamCreateWithFlags(&stream, cudaStreamNonBlocking);
    *stream_out = static_cast<void*>(stream);
    return static_cast<int>(err);
}

// The CUDA runtime's name and description of an error code.
extern "C" const char* sdvl_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
