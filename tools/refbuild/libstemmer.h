/*
 * Identity stand-in for the Snowball libstemmer C API, used ONLY to
 * build the reference engine for the offline head-to-head benchmark
 * (this image does not ship libstemmer).  sb_stemmer_stem() returns
 * the input unchanged, i.e. the reference runs with stemming
 * disabled; the JAX engine is configured the same way
 * (filters=["normalizer"]) so the comparison is apples-to-apples.
 * The head-to-head corpus is synthetic ([a-z0-9] tokens), on which
 * the real Porter2 stemmer is a near-identity anyway.
 *
 * API surface: filters_builtin.c:210-232.
 */

#ifndef _LIBSTEMMER_STUB_H_
#define _LIBSTEMMER_STUB_H_

typedef unsigned char sb_symbol;

struct sb_stemmer;

struct sb_stemmer *sb_stemmer_new(const char *algorithm,
    const char *charenc);
void sb_stemmer_delete(struct sb_stemmer *);
const sb_symbol *sb_stemmer_stem(struct sb_stemmer *,
    const sb_symbol *word, int size);
int sb_stemmer_length(struct sb_stemmer *);

#endif
