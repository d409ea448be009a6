/* Native multithreaded Barnes-Hut engine for the prime/divisor graph
 * layout (2-D quadtree / 3-D octree).
 *
 * Host-side runtime counterpart of solvers/nbody_graph.py (built and
 * bound by solvers/nbody_native.py of fluidsims_tpu_torch):
 * same force law and integrator (spring k*(|d|-L)/|d| with softening, BH
 * repulsion R*m/(d^2+soft), damped clamped velocity step, root pinned),
 * but with the reference's CPU-parallel architecture rebuilt natively
 * (behavioral spec: number_fluid2d.c:44-79 worker pool + sense-reversing
 * barrier, :244-354 tree, :386-438 MAC traversal, :485-523 per-worker
 * force accumulators merged at integration; number_fluid3d.c:255-382
 * octree).  Exactness knob: theta=0 degenerates to the O(n^2) pairwise
 * sum, which the tests compare against an independent NumPy oracle.
 *
 * Build: cc -O2 -shared -fPIC nbody_bh.c -o libnbody_bh.so -lpthread -lm
 * (solvers/nbody_native.py builds it at first use into build/).
 */

#include <math.h>
#include <pthread.h>
#include <sched.h>
#include <stdatomic.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define MAX_THREADS 64
#define MAX_DEPTH 48

typedef struct {
    double cx[3];   /* cell center */
    double hs;      /* half size */
    double mass;
    double com[3];  /* accumulated sum during build; mean after finalize */
    int32_t child[8];
    int32_t head;   /* first body of the leaf chain, -1 if internal */
    int32_t is_leaf;
} Node;

typedef struct {
    atomic_int count;
    int total;
    atomic_int sense;
} Barrier;

typedef struct BHSim {
    int dims, n, n_edges, n_threads;
    const int32_t *edges;  /* (n_edges, 2), caller-owned copy below */
    int32_t *edges_buf;
    double *pos, *vel;     /* (n, dims) */
    /* params */
    double link_length, spring_k, softening, repulsion, damping, dt,
        max_speed, theta;
    /* tree */
    Node *nodes;
    int32_t n_nodes, cap_nodes;
    int32_t *next_body;    /* leaf chains */
    /* per-worker force accumulators, (n_threads, n, dims) */
    double *fbuf;
    /* per-worker bounds slots */
    double wlo[MAX_THREADS][3], whi[MAX_THREADS][3];
    /* pool control */
    pthread_t threads[MAX_THREADS];
    Barrier barrier;
    atomic_int job_gen;
    atomic_int job_steps;
    atomic_int shutdown;
    int senses[MAX_THREADS];
} BHSim;

static void barrier_wait(Barrier *b, int *sense) {
    *sense = !*sense;
    if (atomic_fetch_add_explicit(&b->count, 1, memory_order_acq_rel)
        == b->total - 1) {
        atomic_store_explicit(&b->count, 0, memory_order_relaxed);
        atomic_store_explicit(&b->sense, *sense, memory_order_release);
    } else {
        while (atomic_load_explicit(&b->sense, memory_order_acquire)
               != *sense)
            sched_yield();
    }
}

/* ------------------------------ tree build ------------------------------ */

static int32_t node_alloc(BHSim *s, const double cx[3], double hs) {
    if (s->n_nodes == s->cap_nodes) {
        s->cap_nodes *= 2;
        s->nodes = (Node *)realloc(s->nodes, sizeof(Node) * s->cap_nodes);
    }
    Node *nd = &s->nodes[s->n_nodes];
    memcpy(nd->cx, cx, sizeof(double) * 3);
    nd->hs = hs;
    nd->mass = 0.0;
    nd->com[0] = nd->com[1] = nd->com[2] = 0.0;
    for (int c = 0; c < 8; c++) nd->child[c] = -1;
    nd->head = -1;
    nd->is_leaf = 1;
    return s->n_nodes++;
}

static int octant(const Node *nd, const double *p, int dims) {
    int o = 0;
    for (int d = 0; d < dims; d++)
        if (p[d] >= nd->cx[d]) o |= 1 << d;
    return o;
}

static void child_center(const Node *nd, int o, int dims, double out[3]) {
    double h = nd->hs * 0.5;
    out[2] = 0.0;
    for (int d = 0; d < dims; d++)
        out[d] = nd->cx[d] + ((o >> d) & 1 ? h : -h);
}

static int32_t ensure_child(BHSim *s, int32_t cur, int o) {
    if (s->nodes[cur].child[o] < 0) {
        double cc[3];
        child_center(&s->nodes[cur], o, s->dims, cc);
        int32_t nw = node_alloc(s, cc, s->nodes[cur].hs * 0.5);
        s->nodes[cur].child[o] = nw; /* re-index: node_alloc may realloc */
    }
    return s->nodes[cur].child[o];
}

static void split_leaf(BHSim *s, int32_t cur) {
    /* redistribute the leaf chain one level down (mass/com follow) */
    const int dims = s->dims;
    int32_t old = s->nodes[cur].head;
    s->nodes[cur].head = -1;
    s->nodes[cur].is_leaf = 0;
    while (old >= 0) {
        int32_t nxt = s->next_body[old];
        const double *q = s->pos + (size_t)old * dims;
        int o = octant(&s->nodes[cur], q, dims);
        int32_t ch = ensure_child(s, cur, o);
        Node *cn = &s->nodes[ch];
        cn->mass += 1.0;
        for (int d = 0; d < dims; d++) cn->com[d] += q[d];
        s->next_body[old] = cn->head;
        cn->head = old;
        old = nxt;
    }
}

static void tree_insert(BHSim *s, int32_t root, int32_t b) {
    const int dims = s->dims;
    const double *p = s->pos + (size_t)b * dims;
    int32_t cur = root;
    int depth = 0;
    for (;;) {
        Node *nd = &s->nodes[cur];
        nd->mass += 1.0;
        for (int d = 0; d < dims; d++) nd->com[d] += p[d];
        if (nd->is_leaf) {
            if (nd->head < 0 || depth >= MAX_DEPTH) {
                /* empty leaf, or depth-capped: chain the body */
                s->next_body[b] = nd->head;
                nd->head = b;
                return;
            }
            split_leaf(s, cur); /* cur becomes internal */
        }
        int o = octant(&s->nodes[cur], p, dims);
        cur = ensure_child(s, cur, o);
        depth++;
    }
}

static void tree_build(BHSim *s) {
    const int dims = s->dims;
    double lo[3] = {1e300, 1e300, 1e300}, hi[3] = {-1e300, -1e300, -1e300};
    for (int w = 0; w < s->n_threads; w++)
        for (int d = 0; d < dims; d++) {
            if (s->wlo[w][d] < lo[d]) lo[d] = s->wlo[w][d];
            if (s->whi[w][d] > hi[d]) hi[d] = s->whi[w][d];
        }
    double cx[3] = {0, 0, 0}, hs = 1e-6;
    for (int d = 0; d < dims; d++) {
        cx[d] = 0.5 * (lo[d] + hi[d]);
        double h = 0.5 * (hi[d] - lo[d]);
        if (h > hs) hs = h;
    }
    hs *= 1.0000001; /* bodies strictly inside */
    s->n_nodes = 0;
    int32_t root = node_alloc(s, cx, hs);
    (void)root;
    for (int32_t b = 0; b < s->n; b++) tree_insert(s, 0, b);
}

/* ------------------------------- forces -------------------------------- */

static void repulse_from(const BHSim *s, int32_t node, int32_t b,
                         double *f) {
    const int dims = s->dims;
    const double *p = s->pos + (size_t)b * dims;
    const Node *nd = &s->nodes[node];
    if (nd->mass <= 0.0) return;

    if (nd->is_leaf) {
        for (int32_t j = nd->head; j >= 0; j = s->next_body[j]) {
            if (j == b) continue;
            const double *q = s->pos + (size_t)j * dims;
            double d[3] = {0, 0, 0}, d2 = s->softening;
            for (int k = 0; k < dims; k++) {
                d[k] = p[k] - q[k];
                d2 += d[k] * d[k];
            }
            double inv = 1.0 / sqrt(d2);
            double fm = s->repulsion / d2 * inv;
            for (int k = 0; k < dims; k++) f[k] += fm * d[k];
        }
        return;
    }

    double com[3], draw2 = 0.0;
    for (int k = 0; k < dims; k++) {
        com[k] = nd->com[k] / nd->mass;
        double dd = p[k] - com[k];
        draw2 += dd * dd;
    }
    double size = 2.0 * nd->hs;
    if (size * size < s->theta * s->theta * draw2) {
        double d2 = draw2 + s->softening;
        double inv = 1.0 / sqrt(d2);
        double fm = s->repulsion * nd->mass / d2 * inv;
        for (int k = 0; k < dims; k++) f[k] += fm * (p[k] - com[k]);
        return;
    }
    for (int c = 0; c < 8; c++)
        if (nd->child[c] >= 0) repulse_from(s, nd->child[c], b, f);
}

static void range_of(int total, int w, int W, int *a, int *b) {
    int q = total / W, r = total % W;
    *a = w * q + (w < r ? w : r);
    *b = *a + q + (w < r ? 1 : 0);
}

static void run_steps(BHSim *s, int w, int nsteps) {
    const int dims = s->dims, W = s->n_threads, n = s->n;
    int b0, b1, e0, e1;
    range_of(n, w, W, &b0, &b1);
    range_of(s->n_edges, w, W, &e0, &e1);
    double *myf = s->fbuf + (size_t)w * n * dims;
    int *sense = &s->senses[w];

    for (int it = 0; it < nsteps; it++) {
        /* phase 1: per-worker bounds */
        double lo[3] = {1e300, 1e300, 1e300};
        double hi[3] = {-1e300, -1e300, -1e300};
        for (int i = b0; i < b1; i++)
            for (int d = 0; d < dims; d++) {
                double v = s->pos[(size_t)i * dims + d];
                if (v < lo[d]) lo[d] = v;
                if (v > hi[d]) hi[d] = v;
            }
        memcpy(s->wlo[w], lo, sizeof lo);
        memcpy(s->whi[w], hi, sizeof hi);
        barrier_wait(&s->barrier, sense);

        /* phase 2: serial tree build on worker 0 */
        if (w == 0) tree_build(s);
        barrier_wait(&s->barrier, sense);

        /* phase 3: forces into the private accumulator */
        memset(myf, 0, sizeof(double) * (size_t)n * dims);
        for (int e = e0; e < e1; e++) {
            int32_t src = s->edges[(size_t)e * 2];
            int32_t dst = s->edges[(size_t)e * 2 + 1];
            const double *ps = s->pos + (size_t)src * dims;
            const double *pd = s->pos + (size_t)dst * dims;
            double d[3] = {0, 0, 0}, d2 = s->softening;
            for (int k = 0; k < dims; k++) {
                d[k] = pd[k] - ps[k];
                d2 += d[k] * d[k];
            }
            double inv = 1.0 / sqrt(d2);
            double dist = d2 * inv;
            double fm = s->spring_k * (dist - s->link_length) * inv;
            if (src != 0)
                for (int k = 0; k < dims; k++)
                    myf[(size_t)src * dims + k] += fm * d[k];
            if (dst != 0)
                for (int k = 0; k < dims; k++)
                    myf[(size_t)dst * dims + k] -= fm * d[k];
        }
        for (int i = b0; i < b1; i++)
            repulse_from(s, 0, i, myf + (size_t)i * dims);
        barrier_wait(&s->barrier, sense);

        /* phase 4: merge accumulators + integrate my body range */
        for (int i = b0; i < b1; i++) {
            if (i == 0) {
                for (int k = 0; k < dims; k++) {
                    s->pos[k] = 0.0;
                    s->vel[k] = 0.0;
                }
                continue;
            }
            double f[3] = {0, 0, 0};
            for (int ww = 0; ww < W; ww++)
                for (int k = 0; k < dims; k++)
                    f[k] += s->fbuf[((size_t)ww * n + i) * dims + k];
            double v[3], sp2 = 0.0;
            for (int k = 0; k < dims; k++) {
                v[k] = (s->vel[(size_t)i * dims + k] + f[k] * s->dt)
                       * s->damping;
                sp2 += v[k] * v[k];
            }
            if (sp2 > s->max_speed * s->max_speed) {
                double sc = s->max_speed / sqrt(sp2);
                for (int k = 0; k < dims; k++) v[k] *= sc;
            }
            for (int k = 0; k < dims; k++) {
                s->vel[(size_t)i * dims + k] = v[k];
                s->pos[(size_t)i * dims + k] += v[k] * s->dt;
            }
        }
        barrier_wait(&s->barrier, sense);
    }
}

/* ----------------------------- worker pool ------------------------------ */

typedef struct {
    BHSim *s;
    int w;
} WorkerArg;

static void *worker_main(void *arg) {
    WorkerArg *wa = (WorkerArg *)arg;
    BHSim *s = wa->s;
    int w = wa->w;
    free(wa);
    int gen = 0;
    for (;;) {
        while (atomic_load_explicit(&s->job_gen, memory_order_acquire)
               == gen) {
            if (atomic_load_explicit(&s->shutdown, memory_order_acquire))
                return NULL;
            sched_yield();
        }
        gen = atomic_load_explicit(&s->job_gen, memory_order_acquire);
        run_steps(s, w, atomic_load(&s->job_steps));
    }
}

/* -------------------------------- C API --------------------------------- */

BHSim *bh_create(int dims, int n, const int32_t *edges, int n_edges,
                 const double *params, int n_threads) {
    if (dims < 2 || dims > 3 || n < 1 || n_threads < 1
        || n_threads > MAX_THREADS)
        return NULL;
    BHSim *s = (BHSim *)calloc(1, sizeof(BHSim));
    s->dims = dims;
    s->n = n;
    s->n_edges = n_edges;
    s->n_threads = n_threads;
    s->edges_buf = (int32_t *)malloc(sizeof(int32_t) * (size_t)n_edges * 2);
    memcpy(s->edges_buf, edges, sizeof(int32_t) * (size_t)n_edges * 2);
    s->edges = s->edges_buf;
    s->pos = (double *)calloc((size_t)n * dims, sizeof(double));
    s->vel = (double *)calloc((size_t)n * dims, sizeof(double));
    s->link_length = params[0];
    s->spring_k = params[1];
    s->softening = params[2];
    s->repulsion = params[3];
    s->damping = params[4];
    s->dt = params[5];
    s->max_speed = params[6];
    s->theta = params[7];
    s->cap_nodes = 4 * n + 64;
    s->nodes = (Node *)malloc(sizeof(Node) * s->cap_nodes);
    s->next_body = (int32_t *)malloc(sizeof(int32_t) * n);
    s->fbuf = (double *)malloc(sizeof(double) * (size_t)n_threads * n * dims);
    atomic_init(&s->barrier.count, 0);
    atomic_init(&s->barrier.sense, 0);
    s->barrier.total = n_threads;
    atomic_init(&s->job_gen, 0);
    atomic_init(&s->job_steps, 0);
    atomic_init(&s->shutdown, 0);
    for (int w = 1; w < n_threads; w++) {
        WorkerArg *wa = (WorkerArg *)malloc(sizeof(WorkerArg));
        wa->s = s;
        wa->w = w;
        pthread_create(&s->threads[w], NULL, worker_main, wa);
    }
    return s;
}

void bh_set_state(BHSim *s, const double *pos, const double *vel) {
    memcpy(s->pos, pos, sizeof(double) * (size_t)s->n * s->dims);
    memcpy(s->vel, vel, sizeof(double) * (size_t)s->n * s->dims);
}

void bh_get_state(const BHSim *s, double *pos, double *vel) {
    memcpy(pos, s->pos, sizeof(double) * (size_t)s->n * s->dims);
    memcpy(vel, s->vel, sizeof(double) * (size_t)s->n * s->dims);
}

void bh_run(BHSim *s, int n_steps) {
    if (n_steps <= 0) return;
    atomic_store(&s->job_steps, n_steps);
    atomic_fetch_add_explicit(&s->job_gen, 1, memory_order_release);
    run_steps(s, 0, n_steps);
    /* the final barrier of the last step synchronizes every worker */
}

void bh_destroy(BHSim *s) {
    if (!s) return;
    atomic_store_explicit(&s->shutdown, 1, memory_order_release);
    for (int w = 1; w < s->n_threads; w++) pthread_join(s->threads[w], NULL);
    free(s->edges_buf);
    free(s->pos);
    free(s->vel);
    free(s->nodes);
    free(s->next_body);
    free(s->fbuf);
    free(s);
}
