// Native snapshot writer for fdtd_tpu.
//
// Streams VTK RectilinearGrid (.vtr, appended raw encoding) files without
// any Python-level buffer copies: the XML header is assembled here and the
// field buffers are fwrite()n straight from the caller's memory.  Called
// from Python via ctypes on a background thread (ctypes FFI calls release
// the GIL, so encoding/IO overlaps the simulation step loop) — the
// counterpart of the reference's Silo writer (reference:
// main.c:550-598), minus the serial rank-0 gather bottleneck
// (description.pdf section 5).
//
// Build: make -C native   (g++ -O2 -shared -fPIC)

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

const char* vtk_type(int dtype) { return dtype == 0 ? "Float32" : "Float64"; }
size_t elem_size(int dtype) { return dtype == 0 ? 4 : 8; }

struct Block {
  const void* data;
  size_t nbytes;
};

}  // namespace

extern "C" {

// Write a .vtr file.
//   path:      output file path (written atomically via path + ".tmp")
//   x,y,z:     node coordinate vectors (float64), lengths nx, ny, nz
//   n_arrays:  number of cell-centered arrays
//   names:     array names (NUL-terminated)
//   data:      array payloads, C-order (nz-1, ny-1, nx-1)
//   dtypes:    0 = float32, 1 = float64 per array
// Returns 0 on success, negative errno-style code on failure.
int fdtd_write_vtr(const char* path, const double* x, int nx, const double* y,
                   int ny, const double* z, int nz, int n_arrays,
                   const char** names, const void** data, const int* dtypes) {
  const size_t cells = size_t(nx - 1) * size_t(ny - 1) * size_t(nz - 1);

  std::vector<Block> blocks;
  std::vector<size_t> offsets;
  size_t off = 0;
  auto add_block = [&](const void* ptr, size_t nbytes) {
    offsets.push_back(off);
    blocks.push_back({ptr, nbytes});
    off += 8 + nbytes;  // uint64 size header + payload
    return offsets.back();
  };

  std::string xml;
  xml.reserve(4096);
  char buf[512];
  xml += "<?xml version=\"1.0\"?>\n";
  xml +=
      "<VTKFile type=\"RectilinearGrid\" version=\"1.0\" "
      "byte_order=\"LittleEndian\" header_type=\"UInt64\">\n";
  snprintf(buf, sizeof buf, "  <RectilinearGrid WholeExtent=\"0 %d 0 %d 0 %d\">\n",
           nx - 1, ny - 1, nz - 1);
  xml += buf;
  snprintf(buf, sizeof buf, "    <Piece Extent=\"0 %d 0 %d 0 %d\">\n", nx - 1,
           ny - 1, nz - 1);
  xml += buf;

  xml += "      <Coordinates>\n";
  const char* cnames[3] = {"x", "y", "z"};
  const double* coords[3] = {x, y, z};
  const int csizes[3] = {nx, ny, nz};
  for (int c = 0; c < 3; ++c) {
    size_t o = add_block(coords[c], size_t(csizes[c]) * 8);
    snprintf(buf, sizeof buf,
             "        <DataArray type=\"Float64\" Name=\"%s\" format=\"appended\" "
             "offset=\"%zu\"/>\n",
             cnames[c], o);
    xml += buf;
  }
  xml += "      </Coordinates>\n";

  snprintf(buf, sizeof buf, "      <CellData Scalars=\"%s\">\n",
           n_arrays > 0 ? names[0] : "");
  xml += buf;
  for (int a = 0; a < n_arrays; ++a) {
    size_t o = add_block(data[a], cells * elem_size(dtypes[a]));
    snprintf(buf, sizeof buf,
             "        <DataArray type=\"%s\" Name=\"%s\" format=\"appended\" "
             "offset=\"%zu\"/>\n",
             vtk_type(dtypes[a]), names[a], o);
    xml += buf;
  }
  xml += "      </CellData>\n";
  xml += "    </Piece>\n  </RectilinearGrid>\n";
  xml += "  <AppendedData encoding=\"raw\">\n   _";

  std::string tmp = std::string(path) + ".tmp";
  FILE* f = fopen(tmp.c_str(), "wb");
  if (!f) return -1;
  setvbuf(f, nullptr, _IOFBF, 4 << 20);

  bool ok = fwrite(xml.data(), 1, xml.size(), f) == xml.size();
  for (size_t b = 0; ok && b < blocks.size(); ++b) {
    uint64_t n = blocks[b].nbytes;
    ok = fwrite(&n, 8, 1, f) == 1 &&
         fwrite(blocks[b].data, 1, n, f) == n;
  }
  const char* tail = "\n  </AppendedData>\n</VTKFile>\n";
  ok = ok && fwrite(tail, 1, strlen(tail), f) == strlen(tail);
  ok = (fclose(f) == 0) && ok;
  if (!ok) {
    remove(tmp.c_str());
    return -2;
  }
  if (rename(tmp.c_str(), path) != 0) {
    remove(tmp.c_str());
    return -3;
  }
  return 0;
}

// Raw checkpoint writer: a simple header + N named fp32/fp64 arrays,
// written with large buffered fwrites.  Used by the fast checkpoint path.
int fdtd_write_raw(const char* path, int n_arrays, const char** names,
                   const void** data, const int* dtypes,
                   const int64_t* nelems) {
  std::string tmp = std::string(path) + ".tmp";
  FILE* f = fopen(tmp.c_str(), "wb");
  if (!f) return -1;
  setvbuf(f, nullptr, _IOFBF, 4 << 20);
  const char magic[8] = {'F', 'D', 'T', 'D', 'R', 'A', 'W', '1'};
  bool ok = fwrite(magic, 1, 8, f) == 8;
  int32_t n = n_arrays;
  ok = ok && fwrite(&n, 4, 1, f) == 1;
  for (int a = 0; ok && a < n_arrays; ++a) {
    int32_t name_len = int32_t(strlen(names[a]));
    int32_t dt = dtypes[a];
    int64_t ne = nelems[a];
    ok = fwrite(&name_len, 4, 1, f) == 1 &&
         fwrite(names[a], 1, name_len, f) == size_t(name_len) &&
         fwrite(&dt, 4, 1, f) == 1 && fwrite(&ne, 8, 1, f) == 1 &&
         fwrite(data[a], elem_size(dt), ne, f) == size_t(ne);
  }
  ok = (fclose(f) == 0) && ok;
  if (!ok) {
    remove(tmp.c_str());
    return -2;
  }
  if (rename(tmp.c_str(), path) != 0) {
    remove(tmp.c_str());
    return -3;
  }
  return 0;
}

}  // extern "C"
