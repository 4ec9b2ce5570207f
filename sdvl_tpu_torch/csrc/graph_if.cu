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
//   sdvl_if_begin(parent, body, pred, counter, else_out, kernel_out)
//     1. a one-thread kernel on `parent` (the condition kernel) copies *pred
//        into a new conditional handle (cudaGraphSetConditional) each time
//        the graph runs, and adds 1 to counter[0] of the two uint64 at
//        `counter` (unless it is null);
//     2. an IF node on that handle, after the kernel, becomes the sole
//        dependency of whatever `parent` captures next;
//     3. `body` begins capturing into the node's body graph.
//     Where else_out is not null the node is the first of an if/else pair:
//     the same kernel also sets a second handle (*else_out) to !*pred and
//     adds 1 to counter[1] (the pairs), and *kernel_out is the kernel's
//     node, for sdvl_else_begin.
//   sdvl_else_begin(parent, body, else_handle, kernel_node)
//     after the IF body's capture has ended: an IF node on the pair's
//     second handle, after the same kernel (not after the first node), and
//     `body` capturing into it; `parent` then depends on both nodes. So a
//     branch with an else is one condition-kernel launch, where two IF
//     nodes on pred and on its negation were two launches and a
//     logical_not kernel. (CUDA 12.8 has IF nodes with an else body of
//     their own; this works from 12.4 on.)
//   sdvl_if_end(body)
//     ends the capture of an IF body (the first or the second of a pair).
//
// A loop is a WHILE node, whose body runs again as long as its handle is
// non-zero when the body ends:
//
//   sdvl_while_begin(parent, body, pred, counter, &handle)
//     as sdvl_if_begin, with a WHILE node; the kernel before the node sets
//     the handle from *pred, so the body may run zero times;
//   sdvl_while_end(body, handle, pred, counter)
//     captures the condition kernel at the end of the body, on *pred as
//     the body left it (the caller computes it there: any () bool of the
//     body, read where it lies), then ends the body's capture.
//
// A counted loop (a fori_loop) keeps its index in the condition kernel:
//
//   sdvl_fori_begin(parent, body, index, n, counter, &handle)
//     the kernel before the WHILE node writes *index = 0 (an int32 the
//     caller made before the node) and sets the handle to 0 < n;
//   sdvl_fori_end(body, handle, index, n, counter)
//     the kernel at the end of the body adds 1 to *index and sets the
//     handle to *index < n. `n` travels by value. The body reads *index;
//     no add, compare or copy of the loop's own runs per iteration.
//
// sdvl_stage_mark(stream, acc, stage, first, counter) launches the stage-mark
// kernel, which times the stages of a replay (see stage_mark_kernel).
//
// The caller runs the body's work on `body` in between. Nesting works the
// same way, the body stream of one level being the parent of the next.
// Nothing here synchronises or allocates device memory. Each function returns
// a cudaError_t as an int (0 = success).
//
// What bounds the condition kernel on an H100: not its bytes (a bool or an
// int32 read, a uint64 counter) but the cost of a kernel node in a replay,
// the launch floor, which sdvl_launch_floor's empty kernel measures. So the
// design cuts the kernel nodes around each condition: one kernel per
// if/else pair, and a counted loop's index and compare inside the kernel.
//
// This is the counterpart of the `lax.cond` / `lax.switch`, `while_loop`,
// `fori_loop` and `scan` of the reference's device programs
// (sdvl_tpu/pipeline/device_fsm.py, sdvl_tpu/solvers/ba.py); it replaces no
// Pallas kernel.

#include <cuda_runtime.h>

// What one launch of the condition kernel reads and writes, by value.
struct Condition {
    cudaGraphConditionalHandle handle;      // the node's
    cudaGraphConditionalHandle else_handle; // an if/else pair's second node's
    const bool* pred;      // the predicate; null in a counted loop
    int* index;            // a counted loop's index
    int n;                 // a counted loop's bound
    int start;             // a counted loop: 1 before the node, 0 at the end
                           // of the body
    int has_else;          // set else_handle to the negation too
    unsigned long long* counter;   // launches, then if/else pairs; or null
};

// Sets the node's handle (and an if/else pair's second handle), and counts
// its launches in counter[0] (one per IF node or if/else pair and one per
// WHILE iteration, plus one per WHILE node, each time the graph replays)
// and the if/else pairs among them in counter[1] (counter[2] counts the
// stage marks below).
__global__ void set_condition_kernel(const __grid_constant__ Condition c) {
    unsigned value;
    if (c.pred != nullptr) {
        value = *c.pred ? 1u : 0u;
    } else {
        const int i = c.start ? 0 : *c.index + 1;
        *c.index = i;
        value = i < c.n ? 1u : 0u;
    }
    cudaGraphSetConditional(c.handle, value);
    if (c.has_else) cudaGraphSetConditional(c.else_handle, value ^ 1u);
    if (c.counter != nullptr) {
        atomicAdd(c.counter, 1ull);
        if (c.has_else) atomicAdd(c.counter + 1, 1ull);
    }
}

// An empty one-thread kernel: the least a kernel node of a replay costs.
__global__ void launch_floor_kernel() {}

// Stage marks (sdvl_tpu_torch/utils/trace.py): a graph captured with marks
// owns `acc`, SDVL_MAX_STAGES stage slots of device ns, then as many of
// marks, then the previous mark's %globaltimer reading and slot. A mark of
// stage `stage` adds the time since the previous mark to the previous
// mark's slot and counts itself in its own, so the stages partition the
// replay between its first and its last mark; the graph's first mark
// (`first`) zeroes the slots instead. Each launch adds 1 to counter[2] of
// the condition kernel's counters. One thread: a mark is a launch-floor
// node with a few loads and stores, never in a loop's body but at the
// boundaries of stages that take milliseconds.
#define SDVL_MAX_STAGES 16

__global__ void stage_mark_kernel(unsigned long long* acc, int stage,
                                  int first, unsigned long long* counter) {
    unsigned long long now;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
    unsigned long long* ns = acc;
    unsigned long long* marks = acc + SDVL_MAX_STAGES;
    unsigned long long* last = acc + 2 * SDVL_MAX_STAGES;  // time, slot
    if (first) {
        for (int i = 0; i < SDVL_MAX_STAGES; ++i) {
            ns[i] = 0ull;
            marks[i] = 0ull;
        }
    } else if (last[1] < SDVL_MAX_STAGES) {
        ns[last[1]] += now - last[0];
    }
    marks[stage] += 1ull;
    last[0] = now;
    last[1] = static_cast<unsigned long long>(stage);
    if (counter != nullptr) atomicAdd(counter + 2, 1ull);
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

// The graph `parent` captures into and whether `body` is free to capture a
// node's body (steps 1-4).
static int capture_graph(cudaStream_t parent, cudaStream_t body,
                         cudaGraph_t* graph) {
    cudaStreamCaptureStatus status;
    STEP(1, cudaStreamGetCaptureInfo(parent, &status, nullptr, graph,
                                     nullptr, nullptr));
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
    return 0;
}

// Adds a conditional node of `type` on `handle` after `deps`, makes it a
// dependency of whatever `parent` captures next (`update`: the sole one, or
// one more), and starts `body` capturing into its body graph (steps 8-10).
static int add_node(cudaStream_t parent, cudaStream_t body, cudaGraph_t graph,
                    const cudaGraphNode_t* deps, size_t n_deps,
                    cudaGraphConditionalHandle handle,
                    cudaGraphConditionalNodeType type, unsigned update) {
    cudaGraphNodeParams params = {};
    params.type = cudaGraphNodeTypeConditional;
    params.conditional.handle = handle;
    params.conditional.type = type;
    params.conditional.size = 1;
    cudaGraphNode_t node;
    STEP(8, cudaGraphAddNode(&node, graph, deps, n_deps, &params));
    STEP(9, cudaStreamUpdateCaptureDependencies(parent, &node, 1, update));
    STEP(10, cudaStreamBeginCaptureToGraph(
        body, params.conditional.phGraph_out[0], nullptr, nullptr, 0,
        cudaStreamCaptureModeThreadLocal));
    return 0;
}

// The condition kernel on `parent` (its handles made here), then the node.
static int conditional_begin(void* parent_stream, void* body_stream,
                             Condition cond, cudaGraphConditionalNodeType type,
                             unsigned long long* handle_out,
                             unsigned long long* else_out,
                             void** kernel_out) {
    const cudaStream_t parent = static_cast<cudaStream_t>(parent_stream);
    const cudaStream_t body = static_cast<cudaStream_t>(body_stream);
    cudaGraph_t graph;
    const int err = capture_graph(parent, body, &graph);
    if (err != 0) return err;
    STEP(5, cudaGraphConditionalHandleCreate(&cond.handle, graph, 0,
                                             cudaGraphCondAssignDefault));
    if (else_out != nullptr) {
        STEP(11, cudaGraphConditionalHandleCreate(
            &cond.else_handle, graph, 0, cudaGraphCondAssignDefault));
        cond.has_else = 1;
        *else_out = static_cast<unsigned long long>(cond.else_handle);
    }
    set_condition_kernel<<<1, 1, 0, parent>>>(cond);
    STEP(6, cudaGetLastError());

    // the conditional node goes after the kernel just captured
    cudaStreamCaptureStatus status;
    const cudaGraphNode_t* deps = nullptr;
    size_t n_deps = 0;
    STEP(7, cudaStreamGetCaptureInfo(parent, &status, nullptr, &graph, &deps,
                                     &n_deps));
    if (kernel_out != nullptr) {
        if (n_deps != 1) {
            last_step = 12;     // the kernel is not the one dependency
            return static_cast<int>(cudaErrorIllegalState);
        }
        *kernel_out = static_cast<void*>(deps[0]);
    }
    if (handle_out != nullptr)
        *handle_out = static_cast<unsigned long long>(cond.handle);
    return add_node(parent, body, graph, deps, n_deps, cond.handle, type,
                    cudaStreamSetCaptureDependencies);
}

// The condition kernel at the end of a WHILE body, then the end of its
// capture (whatever the launch gave, so the stream is usable).
static int conditional_end(void* body_stream, const Condition& cond) {
    const cudaStream_t body = static_cast<cudaStream_t>(body_stream);
    set_condition_kernel<<<1, 1, 0, body>>>(cond);
    const cudaError_t launched = cudaGetLastError();
    cudaGraph_t graph;
    const cudaError_t ended = cudaStreamEndCapture(body, &graph);
    return static_cast<int>(launched != cudaSuccess ? launched : ended);
}

static Condition on_pred(const void* pred, void* counter) {
    Condition c = {};
    c.pred = static_cast<const bool*>(pred);
    c.counter = static_cast<unsigned long long*>(counter);
    return c;
}

static Condition counted(void* index, int n, int start, void* counter) {
    Condition c = {};
    c.index = static_cast<int*>(index);
    c.n = n;
    c.start = start;
    c.counter = static_cast<unsigned long long*>(counter);
    return c;
}

extern "C" int sdvl_if_begin(void* parent_stream, void* body_stream,
                             const void* pred, void* counter,
                             unsigned long long* else_out, void** kernel_out) {
    return conditional_begin(parent_stream, body_stream,
                             on_pred(pred, counter), cudaGraphCondTypeIf,
                             nullptr, else_out, kernel_out);
}

extern "C" int sdvl_else_begin(void* parent_stream, void* body_stream,
                               unsigned long long else_handle,
                               void* kernel_node) {
    const cudaStream_t parent = static_cast<cudaStream_t>(parent_stream);
    const cudaStream_t body = static_cast<cudaStream_t>(body_stream);
    cudaGraph_t graph;
    const int err = capture_graph(parent, body, &graph);
    if (err != 0) return err;
    const cudaGraphNode_t kernel = static_cast<cudaGraphNode_t>(kernel_node);
    return add_node(parent, body, graph, &kernel, 1,
                    static_cast<cudaGraphConditionalHandle>(else_handle),
                    cudaGraphCondTypeIf, cudaStreamAddCaptureDependencies);
}

extern "C" int sdvl_if_end(void* body_stream) {
    cudaGraph_t graph;
    return static_cast<int>(
        cudaStreamEndCapture(static_cast<cudaStream_t>(body_stream), &graph));
}

extern "C" int sdvl_while_begin(void* parent_stream, void* body_stream,
                                const void* pred, void* counter,
                                unsigned long long* handle_out) {
    return conditional_begin(parent_stream, body_stream,
                             on_pred(pred, counter), cudaGraphCondTypeWhile,
                             handle_out, nullptr, nullptr);
}

extern "C" int sdvl_while_end(void* body_stream, unsigned long long handle,
                              const void* pred, void* counter) {
    Condition c = on_pred(pred, counter);
    c.handle = static_cast<cudaGraphConditionalHandle>(handle);
    return conditional_end(body_stream, c);
}

extern "C" int sdvl_fori_begin(void* parent_stream, void* body_stream,
                               void* index, int n, void* counter,
                               unsigned long long* handle_out) {
    return conditional_begin(parent_stream, body_stream,
                             counted(index, n, 1, counter),
                             cudaGraphCondTypeWhile, handle_out, nullptr,
                             nullptr);
}

extern "C" int sdvl_fori_end(void* body_stream, unsigned long long handle,
                             void* index, int n, void* counter) {
    Condition c = counted(index, n, 0, counter);
    c.handle = static_cast<cudaGraphConditionalHandle>(handle);
    return conditional_end(body_stream, c);
}

// One launch of the empty kernel on `stream` (timing only).
extern "C" int sdvl_launch_floor(void* stream) {
    launch_floor_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>();
    return static_cast<int>(cudaGetLastError());
}

// One stage mark on `stream` (see stage_mark_kernel).
extern "C" int sdvl_stage_mark(void* stream, void* acc, int stage, int first,
                               void* counter) {
    if (stage < 0 || stage >= SDVL_MAX_STAGES)
        return static_cast<int>(cudaErrorInvalidValue);
    stage_mark_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<unsigned long long*>(acc), stage, first,
        static_cast<unsigned long long*>(counter));
    return static_cast<int>(cudaGetLastError());
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
