/* The host copy of the upload ring (programs._Ring): one band of a frame
 * into a pinned slot, over a few native threads that never take the
 * Python interpreter's lock.
 *
 * A pool holds `workers` threads, made once and kept for the life of the
 * process. A copy cuts the bytes into chunks of COPY_CHUNK; the caller
 * publishes it and then claims chunks itself, as each worker does once it
 * runs, from one atomic counter tagged with the copy's generation. A
 * worker that is late, or never scheduled, claims nothing: the caller
 * copies what is left, so a copy waits at most for the chunks already
 * claimed, never for a thread to start, and is right with no worker at
 * all (after a fork, say). Between copies the workers sleep on a
 * condition variable: a worker that spun there instead would take a core
 * from the caller's next steps. A copy wakes as many workers as its
 * caller asks for (each wake costs the caller a system call and the
 * woken thread a core), and a worker still awake from the last copy
 * joins in as well. Small chunks keep the wait for a worker that is
 * descheduled while it copies one short. One caller at a time per pool.
 */

#include <pthread.h>
#include <sched.h>
#include <stdatomic.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#ifndef COPY_CHUNK
#define COPY_CHUNK (64L << 10)
#endif
#define COPY_MAX_WORKERS 16

typedef struct {
    char *dst;
    const char *src;
    long n, nchunks;
} copy_job;

typedef struct {
    pthread_mutex_t mu;
    pthread_cond_t wake;
    int workers;
    copy_job job;            /* the newest copy's bytes; under mu */
    _Atomic uint32_t gen;    /* the newest copy; written under mu */
    _Atomic uint64_t claim;  /* gen << 32 | the next chunk to copy */
    _Atomic long done;       /* chunks of the newest copy copied */
} copy_pool;

/* Claim and copy chunks of copy `gen` until none is left or a newer copy
 * has begun. */
static void copy_chunks(copy_pool *p, uint32_t gen, const copy_job *job) {
    uint64_t cur = atomic_load(&p->claim);
    for (;;) {
        if ((uint32_t)(cur >> 32) != gen) return;
        long i = (long)(cur & 0xffffffffu);
        if (i >= job->nchunks) return;
        if (!atomic_compare_exchange_weak(&p->claim, &cur, cur + 1)) continue;
        long at = i * COPY_CHUNK;
        long len = job->n - at < COPY_CHUNK ? job->n - at : COPY_CHUNK;
        memcpy(job->dst + at, job->src + at, (size_t)len);
        atomic_fetch_add(&p->done, 1);
        cur = atomic_load(&p->claim);
    }
}

static void *copy_worker(void *arg) {
    copy_pool *p = arg;
    uint32_t seen = 0;
    pthread_mutex_lock(&p->mu);
    for (;;) {
        while (atomic_load(&p->gen) == seen) pthread_cond_wait(&p->wake, &p->mu);
        seen = atomic_load(&p->gen);
        copy_job job = p->job;
        pthread_mutex_unlock(&p->mu);
        copy_chunks(p, seen, &job);
        pthread_mutex_lock(&p->mu);
    }
    return NULL;
}

/* A pool of `workers` threads (at most COPY_MAX_WORKERS; those that fail
 * to start are left out); NULL when out of memory. */
void *dmmt_copy_pool_new(int workers) {
    copy_pool *p = calloc(1, sizeof *p);
    if (!p) return NULL;
    pthread_mutex_init(&p->mu, NULL);
    pthread_cond_init(&p->wake, NULL);
    if (workers > COPY_MAX_WORKERS) workers = COPY_MAX_WORKERS;
    for (int t = 0; t < workers; t++) {
        pthread_t tid;
        if (pthread_create(&tid, NULL, copy_worker, p) == 0) {
            pthread_detach(tid);
            p->workers++;
        }
    }
    return p;
}

/* dst[0:n] = src[0:n] (the ranges do not overlap), by this thread and up
 * to `helpers` of the pool's workers woken for it; returns once every byte
 * is copied. */
void dmmt_copy_pool_run(void *pool, char *dst, const char *src, long n, int helpers) {
    copy_pool *p = pool;
    copy_job job = {dst, src, n, (n + COPY_CHUNK - 1) / COPY_CHUNK};
    pthread_mutex_lock(&p->mu);
    uint32_t gen = atomic_load(&p->gen) + 1;
    p->job = job;
    atomic_store(&p->done, 0);
    atomic_store(&p->claim, (uint64_t)gen << 32);
    atomic_store(&p->gen, gen);
    if (helpers > job.nchunks - 1) helpers = (int)(job.nchunks - 1);
    if (helpers >= p->workers)
        pthread_cond_broadcast(&p->wake);
    else
        for (int t = 0; t < helpers; t++) pthread_cond_signal(&p->wake);
    pthread_mutex_unlock(&p->mu);
    copy_chunks(p, gen, &job);
    /* only chunks a worker has claimed and is copying are left */
    for (long spins = 0; atomic_load(&p->done) < job.nchunks; spins++)
        if (spins >= 4096) sched_yield();
}
