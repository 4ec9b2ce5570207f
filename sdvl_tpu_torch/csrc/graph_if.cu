// IF nodes of a CUDA graph, added while a stream captures (CUDA 12.4+).
//
// A graph captured from eager PyTorch code records the kernels of one path
// through the code. The SLAM step branches on device values (is the stream
// LOST, was the frame good, is it a keyframe); as a graph, each branch is a
// conditional node whose body runs only where a () bool tensor on the device
// is true when the graph replays. This file adds such a node to the graph a
// stream is capturing, and starts a second stream capturing into its body:
//
//   sdvl_if_begin(parent, body, pred)
//     1. a one-thread kernel on `parent` copies *pred into a new conditional
//        handle (cudaGraphSetConditional) each time the graph runs;
//     2. an IF node on that handle, after the kernel, becomes the sole
//        dependency of whatever `parent` captures next;
//     3. `body` begins capturing into the node's body graph.
//   sdvl_if_end(body)
//     ends the body's capture.
//
// The caller runs the body's work on `body` in between. Nesting works the
// same way, the body stream of one level being the parent of the next.
// Nothing here synchronises or allocates device memory. Each function returns
// a cudaError_t as an int (0 = success).
//
// This is the counterpart of the `lax.cond` / `lax.switch` of the reference's
// one-program step (sdvl_tpu/pipeline/device_fsm.py); it replaces no Pallas
// kernel.

#include <cuda_runtime.h>

__global__ void set_condition_kernel(cudaGraphConditionalHandle handle,
                                     const bool* pred) {
    cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

extern "C" int sdvl_if_begin(void* parent_stream, void* body_stream,
                             const void* pred) {
    const cudaStream_t parent = static_cast<cudaStream_t>(parent_stream);
    const cudaStream_t body = static_cast<cudaStream_t>(body_stream);
    cudaStreamCaptureStatus status;
    cudaGraph_t graph;
    const cudaGraphNode_t* deps = nullptr;
    size_t n_deps = 0;
    cudaError_t err = cudaStreamGetCaptureInfo(parent, &status, nullptr,
                                               &graph, &deps, &n_deps);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (status != cudaStreamCaptureStatusActive)
        return static_cast<int>(cudaErrorStreamCaptureImplicit);

    cudaGraphConditionalHandle handle;
    err = cudaGraphConditionalHandleCreate(&handle, graph, 0,
                                           cudaGraphCondAssignDefault);
    if (err != cudaSuccess) return static_cast<int>(err);
    set_condition_kernel<<<1, 1, 0, parent>>>(
        handle, static_cast<const bool*>(pred));
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);

    // the IF node goes after the kernel just captured
    err = cudaStreamGetCaptureInfo(parent, &status, nullptr, &graph, &deps,
                                   &n_deps);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaGraphNodeParams params = {};
    params.type = cudaGraphNodeTypeConditional;
    params.conditional.handle = handle;
    params.conditional.type = cudaGraphCondTypeIf;
    params.conditional.size = 1;
    cudaGraphNode_t node;
    err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaStreamUpdateCaptureDependencies(
        parent, &node, 1, cudaStreamSetCaptureDependencies);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaStreamBeginCaptureToGraph(
        body, params.conditional.phGraph_out[0], nullptr, nullptr, 0,
        cudaStreamCaptureModeThreadLocal));
}

extern "C" int sdvl_if_end(void* body_stream) {
    cudaGraph_t graph;
    return static_cast<int>(
        cudaStreamEndCapture(static_cast<cudaStream_t>(body_stream), &graph));
}
