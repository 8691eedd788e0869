// HDF5 filter plugin for SZ3-format compression, filter id 32024.
//
// Drop-in for the reference H5Z-SZ3 (tools/H5Z-SZ3/src/H5Z_SZ3.cpp):
//  - set_local infers dtype (SZ_FLOAT..SZ_UINT64) and chunk dims from the
//    dataset and merges them into the Config carried in cd_values
//    (reference :74-151);
//  - the filter function round-trips full SZ3 containers per chunk
//    (reference :179-233), skipping arrays with fewer than 20 elements;
//  - chunks written here decompress with the reference filter and vice
//    versa (the payload is a standard self-describing SZ3 archive).
//
// Built without HDF5 headers: the public filter ABI (H5Z_class2_t, 1.8+)
// is declared locally and every libhdf5 entry point is resolved with dlsym
// at registration time — h5zszt_register(path_to_libhdf5) dlopens the same
// shared object the host process (e.g. h5py) already mapped, so the filter
// registers into that library's state. H5PLget_plugin_type/info are also
// exported for the standard HDF5_PLUGIN_PATH mechanism.
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <dlfcn.h>
#include <vector>

#include "szt/container.hpp"

using namespace szt;

extern "C" {

// ---- minimal HDF5 public ABI (stable since 1.8) ------------------------------

typedef int64_t hid_t;
typedef int herr_t;
typedef int htri_t;
typedef uint64_t hsize_t;
typedef int H5Z_filter_t;

typedef htri_t (*H5Z_can_apply_func_t)(hid_t dcpl_id, hid_t type_id, hid_t space_id);
typedef herr_t (*H5Z_set_local_func_t)(hid_t dcpl_id, hid_t type_id, hid_t space_id);
typedef size_t (*H5Z_func_t)(unsigned int flags, size_t cd_nelmts, const unsigned int cd_values[],
                             size_t nbytes, size_t* buf_size, void** buf);

typedef struct H5Z_class2_t {
    int version;
    H5Z_filter_t id;
    unsigned encoder_present;
    unsigned decoder_present;
    const char* name;
    H5Z_can_apply_func_t can_apply;
    H5Z_set_local_func_t set_local;
    H5Z_func_t filter;
} H5Z_class2_t;

enum { H5Z_CLASS_T_VERS = 1 };
enum { H5Z_FLAG_MANDATORY = 0x0000, H5Z_FLAG_REVERSE = 0x0100 };
enum { H5T_INTEGER = 0, H5T_FLOAT = 1 };
enum { H5T_SGN_NONE = 0 };
enum { H5S_MAX_RANK = 32 };
#define H5Z_FILTER_SZ3 32024

}  // extern "C"

namespace {

struct H5Api {
    herr_t (*H5Zregister)(const void* cls) = nullptr;
    htri_t (*H5Zfilter_avail)(H5Z_filter_t id) = nullptr;
    int (*H5Tget_class)(hid_t) = nullptr;
    size_t (*H5Tget_size)(hid_t) = nullptr;
    int (*H5Tget_sign)(hid_t) = nullptr;
    int (*H5Sget_simple_extent_dims)(hid_t, hsize_t*, hsize_t*) = nullptr;
    herr_t (*H5Pmodify_filter)(hid_t, H5Z_filter_t, unsigned, size_t, const unsigned*) = nullptr;
    herr_t (*H5Pset_filter)(hid_t, H5Z_filter_t, unsigned, size_t, const unsigned*) = nullptr;
    H5Z_filter_t (*H5Pget_filter_by_id2)(hid_t, H5Z_filter_t, unsigned*, size_t*, unsigned*,
                                         size_t, char*, unsigned*) = nullptr;
    bool ok = false;
};

H5Api g_api;

bool resolve_api(void* handle) {
    auto sym = [&](const char* name) -> void* {
        void* p = handle ? dlsym(handle, name) : dlsym(RTLD_DEFAULT, name);
        return p;
    };
    g_api.H5Zregister = reinterpret_cast<decltype(g_api.H5Zregister)>(sym("H5Zregister"));
    g_api.H5Zfilter_avail = reinterpret_cast<decltype(g_api.H5Zfilter_avail)>(sym("H5Zfilter_avail"));
    g_api.H5Tget_class = reinterpret_cast<decltype(g_api.H5Tget_class)>(sym("H5Tget_class"));
    g_api.H5Tget_size = reinterpret_cast<decltype(g_api.H5Tget_size)>(sym("H5Tget_size"));
    g_api.H5Tget_sign = reinterpret_cast<decltype(g_api.H5Tget_sign)>(sym("H5Tget_sign"));
    g_api.H5Sget_simple_extent_dims =
        reinterpret_cast<decltype(g_api.H5Sget_simple_extent_dims)>(sym("H5Sget_simple_extent_dims"));
    g_api.H5Pmodify_filter = reinterpret_cast<decltype(g_api.H5Pmodify_filter)>(sym("H5Pmodify_filter"));
    g_api.H5Pset_filter = reinterpret_cast<decltype(g_api.H5Pset_filter)>(sym("H5Pset_filter"));
    g_api.H5Pget_filter_by_id2 =
        reinterpret_cast<decltype(g_api.H5Pget_filter_by_id2)>(sym("H5Pget_filter_by_id2"));
    g_api.ok = g_api.H5Zregister && g_api.H5Tget_class && g_api.H5Tget_size &&
               g_api.H5Sget_simple_extent_dims && g_api.H5Pmodify_filter && g_api.H5Pset_filter &&
               g_api.H5Pget_filter_by_id2 && g_api.H5Tget_sign;
    return g_api.ok;
}

// dtype id from the HDF5 datatype (reference H5Z_SZ3.cpp:106-139)
uint8_t dtype_from_h5(hid_t type_id) {
    int dclass = g_api.H5Tget_class(type_id);
    size_t dsize = g_api.H5Tget_size(type_id);
    if (dclass == H5T_FLOAT) return dsize == 4 ? 0 : 1;
    if (dclass == H5T_INTEGER) {
        bool uns = g_api.H5Tget_sign(type_id) == H5T_SGN_NONE;
        switch (dsize) {
            case 1: return uns ? 2 : 3;
            case 2: return uns ? 4 : 5;
            case 4: return uns ? 6 : 7;
            case 8: return uns ? 8 : 9;
        }
    }
    return 255;
}

herr_t h5z_szt_set_local(hid_t dcpl_id, hid_t type_id, hid_t chunk_space_id) {
    if (!g_api.ok) return -1;

    // existing user-provided Config (error bounds etc.) from cd_values
    Conf conf;
    size_t cd_nelmts = 64;
    std::vector<unsigned> cd_values(cd_nelmts, 0);
    unsigned flags = 0;
    if (g_api.H5Pget_filter_by_id2(dcpl_id, H5Z_FILTER_SZ3, &flags, &cd_nelmts, cd_values.data(),
                                   0, nullptr, nullptr) >= 0 &&
        cd_nelmts > 0) {
        try {
            Source src(reinterpret_cast<const uint8_t*>(cd_values.data()),
                       cd_nelmts * sizeof(unsigned));
            conf.load(src);
        } catch (...) {
            conf = Conf();
        }
    }

    uint8_t dt = dtype_from_h5(type_id);
    if (dt == 255) return -1;
    conf.dataType = dt;

    hsize_t dims_all[H5S_MAX_RANK];
    int ndims = g_api.H5Sget_simple_extent_dims(chunk_space_id, dims_all, nullptr);
    if (ndims < 0) return -1;
    std::vector<size_t> dims(dims_all, dims_all + ndims);
    conf.set_dims(dims);

    Sink s;
    conf.save(s);
    size_t n_ints = (s.size() + sizeof(unsigned) - 1) / sizeof(unsigned);
    std::vector<unsigned> new_cd(n_ints, 0);
    std::memcpy(new_cd.data(), s.buf.data(), s.size());
    if (g_api.H5Pmodify_filter(dcpl_id, H5Z_FILTER_SZ3, H5Z_FLAG_MANDATORY, n_ints,
                               new_cd.data()) < 0)
        return -1;
    return 1;
}

size_t h5z_szt_filter(unsigned flags, size_t cd_nelmts, const unsigned cd_values[], size_t nbytes,
                      size_t* buf_size, void** buf) {
    if (cd_nelmts == 0) return nbytes;  // special data (strings) pass through
    try {
        Conf conf;
        Source src(reinterpret_cast<const uint8_t*>(cd_values), cd_nelmts * sizeof(unsigned));
        conf.load(src);
        if (conf.num() < 20) return nbytes;  // reference :192

        bool is_decompress = flags & H5Z_FLAG_REVERSE;
        size_t out_size = 0;
        void* out_buf = nullptr;
        // free the staging buffer if the codec throws mid-chunk
        struct Guard {
            void** p;
            ~Guard() { if (*p) std::free(*p); }
        } guard{&out_buf};
        auto run = [&](auto* tp) {
            using T = std::remove_pointer_t<decltype(tp)>;
            if (is_decompress) {
                Conf k;
                out_buf = std::malloc(conf.num() * sizeof(T));
                if (!out_buf) throw std::bad_alloc();
                container_decompress<T>(static_cast<const uint8_t*>(*buf), nbytes, k,
                                        static_cast<T*>(out_buf));
                out_size = conf.num() * sizeof(T);
            } else {
                auto blob = container_compress<T>(conf, static_cast<const T*>(*buf));
                out_buf = std::malloc(blob.size());
                if (!out_buf) throw std::bad_alloc();
                std::memcpy(out_buf, blob.data(), blob.size());
                out_size = blob.size();
            }
        };
        switch (conf.dataType) {
            case 0: run(static_cast<float*>(nullptr)); break;
            case 1: run(static_cast<double*>(nullptr)); break;
            case 2: run(static_cast<uint8_t*>(nullptr)); break;
            case 3: run(static_cast<int8_t*>(nullptr)); break;
            case 4: run(static_cast<uint16_t*>(nullptr)); break;
            case 5: run(static_cast<int16_t*>(nullptr)); break;
            case 6: run(static_cast<uint32_t*>(nullptr)); break;
            case 7: run(static_cast<int32_t*>(nullptr)); break;
            case 8: run(static_cast<uint64_t*>(nullptr)); break;
            case 9: run(static_cast<int64_t*>(nullptr)); break;
            default: return 0;
        }
        std::free(*buf);
        *buf = out_buf;
        out_buf = nullptr;  // ownership handed to HDF5; disarm the guard
        *buf_size = out_size;
        return out_size;
    } catch (const std::exception& e) {
        std::fprintf(stderr, "h5z-szt filter error: %s\n", e.what());
        return 0;
    }
}

const H5Z_class2_t kFilterClass = {
    H5Z_CLASS_T_VERS,
    H5Z_FILTER_SZ3,
    1,
    1,
    "SZ3 compressor/decompressor for floating-point data.",
    nullptr,
    h5z_szt_set_local,
    h5z_szt_filter,
};

}  // namespace

extern "C" {

// standard HDF5 plugin discovery (H5PL_TYPE_FILTER == 0)
int H5PLget_plugin_type(void) { return 0; }
const void* H5PLget_plugin_info(void) {
    if (!g_api.ok) resolve_api(nullptr);  // host loaded us: its libhdf5 is visible
    return &kFilterClass;
}

// explicit registration against a specific libhdf5 (e.g. h5py's bundled one);
// path==NULL resolves from already-visible symbols
int h5zszt_register(const char* libhdf5_path) {
    void* handle = nullptr;
    if (libhdf5_path && *libhdf5_path) {
        handle = dlopen(libhdf5_path, RTLD_NOW | RTLD_GLOBAL);
        if (!handle) {
            std::fprintf(stderr, "h5zszt_register: dlopen failed: %s\n", dlerror());
            return -1;
        }
    }
    if (!resolve_api(handle)) {
        std::fprintf(stderr, "h5zszt_register: could not resolve HDF5 symbols\n");
        return -2;
    }
    if (g_api.H5Zfilter_avail && g_api.H5Zfilter_avail(H5Z_FILTER_SZ3) > 0) return 0;
    if (g_api.H5Zregister(&kFilterClass) < 0) return -3;
    return 0;
}

}  // extern "C"
